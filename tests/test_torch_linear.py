"""The headline slice of the PyTorch port, ``LinearSpectralExplicit`` with the
fused RK stage, against the JAX package and against physics:

* the JAX model built with ``FUS_PALLAS=1`` (Pallas interpret mode) and the
  port, run from the same state with the consts carried across by
  ``convert.py``, agree to 1e-12 after 5 RK4 steps (fp64), constant and
  heterogeneous media — and the port's own host setup gives the same consts;
* the 3D plane-wave channel meets the reference gate rel-L2 < 1e-3;
* the fused step equals the unfused reference step for RK orders 1-4, and
  the discrete energy of a closed box does not grow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsxfus_tpu.core.mesh import create_box as jax_create_box
from fenicsxfus_tpu.core.mesh import tag_boundaries as jax_tag_boundaries
from fenicsxfus_tpu.models.linear import LinearSpectralExplicit as JaxLinear
from fenicsxfus_tpu_torch import LinearSpectralExplicit, create_box, tag_boundaries
from fenicsxfus_tpu_torch.analysis.analytical import planewave
from fenicsxfus_tpu_torch.analysis.error import relative_l2_error
from fenicsxfus_tpu_torch.convert import consts_from_numpy, state_from_numpy
from fenicsxfus_tpu_torch.models.common import make_scan_from_step

torch.set_num_threads(1)

L = 1.0
DT = 1e-8


def _tag(mod_tag, mesh):
    mod_tag(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    return mesh


def _media(hetero, nc):
    rng = np.random.default_rng(2)
    c0 = rng.uniform(1400, 1600, nc) if hetero else 1500.0
    rho0 = rng.uniform(900, 1100, nc) if hetero else 1000.0
    return c0, rho0


def _args(c0, rho0, order=4):
    return dict(meshtags=None, degree=3, c0=c0, rho0=rho0, freq0=0.5e6, p0=6e4,
                s0=1500.0, rk_order=order, dt=DT)


def _as_numpy(consts):
    return {
        k: ({n: np.asarray(a) for n, a in v.items()} if isinstance(v, dict)
            else float(v) if np.ndim(v) == 0 else np.asarray(v))
        for k, v in consts.items()
    }


def _assert_close(a, b, tol):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    err = float(np.max(np.abs(a - b))) / scale
    assert err < tol, err


@pytest.mark.parametrize("hetero", [False, True])
def test_slice_matches_jax(hetero, monkeypatch):
    monkeypatch.setenv("FUS_PALLAS", "1")  # Pallas stage kernels, interpret mode
    grid, hi = (6, 4, 4), (L, 0.5, 0.5)
    jmesh = _tag(jax_tag_boundaries, jax_create_box(grid, (0, 0, 0), hi))
    c0, rho0 = _media(hetero, jmesh.num_cells)
    jm = JaxLinear(jmesh, dtype=jnp.float64, **_args(c0, rho0))
    assert jm._try_build_fused() is not None, "JAX fused path not taken"
    tm = LinearSpectralExplicit(_tag(tag_boundaries, create_box(grid, (0, 0, 0), hi)),
                                dtype=torch.float64, device="cpu", **_args(c0, rho0))
    assert tm.step_kind == "fused"

    # the port's own host setup == the JAX consts carried across
    converted = consts_from_numpy(_as_numpy(jm.consts), device="cpu")
    assert set(converted) == set(tm.consts)
    for k, v in converted.items():
        if isinstance(v, dict):
            assert set(v) == set(tm.consts[k])
            for n in v:
                _assert_close(tm.consts[k][n], v[n], 1e-14)
        elif isinstance(v, float):
            assert v == tm.consts[k]
        else:
            _assert_close(tm.consts[k], v, 1e-14)

    # 5 RK4 steps from the same nonzero state, port running the JAX consts
    rng = np.random.default_rng(5)
    u0, v0 = (rng.standard_normal(jm.ops.ndofs) for _ in range(2))
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    ju, jv, jt = jm.rk(0.0, 5 * DT)
    tm.consts = converted
    tm.u_n, tm.v_n = state_from_numpy(u0, v0, device="cpu")
    tu, tv, tt = tm.rk(0.0, 5 * DT)
    assert tt == pytest.approx(float(jt), rel=1e-15)
    _assert_close(tu, ju, 1e-12)
    _assert_close(tv, jv, 1e-12)


def test_planewave_gate():
    """The reference's plane-wave gate (``tests/test_models_1d.py:47-62``) in a
    3D channel: source at x=0, ABC at x=1, p=4, 4 elements per wavelength."""
    f0, c0, rho0, degree = 10.0, 1.0, 4.0, 4
    p0 = rho0 * c0
    mesh = _tag(tag_boundaries, create_box((41, 1, 1), (0, 0, 0), (1.0, 0.1, 0.1)))
    dt = 0.9 * (1.0 / 41) / (c0 * degree**2)
    model = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                   dtype=torch.float64, device="cpu")
    assert model.step_kind == "fused" and model.number_of_dofs() == 4125
    model.init()
    u, _, tf = model.rk(0.0, 1.0 / c0 + 16.0 / f0)
    err = relative_l2_error(model.ops, u, lambda x: planewave(x[0], tf, c0, f0, p0))
    assert err < 1e-3, err


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_fused_step_matches_unfused(order):
    mesh = _tag(tag_boundaries, create_box((5, 3, 4), (0, 0, 0), (L, 0.5, 0.5)))
    c0, rho0 = _media(True, mesh.num_cells)
    model = LinearSpectralExplicit(mesh, dtype=torch.float64, device="cpu", **_args(c0, rho0, order))
    assert model.step_kind == "fused"
    rng = np.random.default_rng(order)
    u0, v0 = (torch.from_numpy(rng.standard_normal(model.ops.ndofs)) for _ in range(2))
    fused = make_scan_from_step(model.fused_step())
    unfused = make_scan_from_step(model.unfused_step())
    uf, vf, _ = fused(model.consts, u0, v0, 0.0, 5 * DT, DT)
    ur, vr, _ = unfused(model.consts, u0, v0, 0.0, 5 * DT, DT)
    _assert_close(uf, ur, 1e-12)
    _assert_close(vf, vr, 1e-12)


def test_closed_box_energy_does_not_grow():
    """No source, no ABC: RK4 keeps the discrete energy ½vᵀMv + ½uᵀKu up to
    its own (small, dissipative) error."""
    mesh = create_box((4, 3, 3), (0, 0, 0), (1.0, 0.75, 0.75))
    c0, degree = 1.0, 3
    dt = 0.5 * 0.25 / (c0 * degree**2)
    model = LinearSpectralExplicit(mesh, None, degree, c0, 1.0, 1.0, 1.0, c0, 4, dt,
                                   dtype=torch.float64, device="cpu")
    model.u_n = model.ops.interpolate(
        lambda x: np.sin(np.pi * x[0]) * np.cos(np.pi * x[1] / 0.75) * np.cos(np.pi * x[2] / 0.75)
    )
    e0 = model.energy()
    model.rk(0.0, 20 * dt)
    e1 = model.energy()
    assert 0.99 * e0 < e1 <= e0 * (1 + 1e-12), (e0, e1)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mesh = create_box((2, 2, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        LinearSpectralExplicit(mesh, dtype=torch.float32, device="cuda", **_args(1500.0, 1000.0))
