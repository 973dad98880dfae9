"""The lossy, Westervelt and focused models of the PyTorch port against the
JAX package (fp64, constant and heterogeneous media), mirroring
``tests/test_pallas.py:58-154``:

* the port's host setup gives the JAX consts (carried across by
  ``convert.py``) to 1e-12;
* 5 RK4 steps of the port's fused step (plain K2 on the CPU) from the same
  state equal the JAX model run with ``FUS_PALLAS=0`` to 1e-12 (the JAX
  suite holds its fused Pallas stage to that same run, interpret mode);
* the port's fused step equals its unfused step (two-field K1 plus
  elementwise torch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsxfus_tpu.core.mesh import create_box as jax_create_box
from fenicsxfus_tpu.core.mesh import tag_boundaries as jax_tag_boundaries
from fenicsxfus_tpu.models.focused import WesterveltSpectralFocused as JaxFocused
from fenicsxfus_tpu.models.lossy import LossySpectralExplicit as JaxLossy
from fenicsxfus_tpu.models.westervelt import WesterveltSpectralExplicit as JaxWestervelt
from fenicsxfus_tpu_torch import (
    LossySpectralExplicit,
    WesterveltSpectralExplicit,
    WesterveltSpectralFocused,
    create_box,
    tag_boundaries,
)
from fenicsxfus_tpu_torch.convert import consts_from_numpy, state_from_numpy
from fenicsxfus_tpu_torch.models.common import make_scan_from_step

torch.set_num_threads(1)

L = 1.0
DT = 1e-8
GRID, HI = (6, 4, 4), (L, 0.5, 0.5)
# class pairs (JAX, port), model arguments, and facet tags of each case
MODELS = {
    "lossy": (JaxLossy, LossySpectralExplicit, dict(delta0=4e-3), "ends"),
    "westervelt": (JaxWestervelt, WesterveltSpectralExplicit,
                   dict(delta0=4e-3, beta0=3.5), "ends"),
    "focused": (JaxFocused, WesterveltSpectralFocused,
                dict(delta0=4e-3, beta0=3.5, aperture_radius=0.2, focal_distance=0.6,
                     center=np.array([0.0, 0.25, 0.25])), "aperture"),
}


def _mesh(mod_create, mod_tag, tags):
    mesh = mod_create(GRID, (0, 0, 0), HI)
    if tags == "ends":
        mod_tag(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    else:  # the HITU layout: source on x=0, ABC on every other face
        mod_tag(mesh, {1: lambda x: x[0] < 1e-12}, default=2)
    return mesh


def _media(hetero, nc):
    rng = np.random.default_rng(2)
    c0 = rng.uniform(1400, 1600, nc) if hetero else 1500.0
    rho0 = rng.uniform(900, 1100, nc) if hetero else 1000.0
    return c0, rho0


def _args(name, hetero, nc):
    c0, rho0 = _media(hetero, nc)
    return dict(meshtags=None, degree=3, c0=c0, rho0=rho0, freq0=0.5e6, p0=6e4,
                s0=1500.0, rk_order=4, dt=DT, **MODELS[name][2])


def _jax_model(name, hetero):
    mesh = _mesh(jax_create_box, jax_tag_boundaries, MODELS[name][3])
    return MODELS[name][0](mesh, dtype=jnp.float64, **_args(name, hetero, mesh.num_cells))


def _port_model(name, hetero):
    mesh = _mesh(create_box, tag_boundaries, MODELS[name][3])
    return MODELS[name][1](mesh, dtype=torch.float64, device="cpu",
                           **_args(name, hetero, mesh.num_cells))


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


def _state(n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name, hetero, monkeypatch):
    tm = _port_model(name, hetero)
    assert tm.step_kind == "fused"

    # the port's own host setup == the JAX consts (packed as for the Pallas
    # stage, which only the packing of the stiffness coefficients needs)
    monkeypatch.setenv("FUS_PALLAS", "1")
    jm_packed = _jax_model(name, hetero)
    assert jm_packed._try_build_fused() is not None, "JAX fused path not taken"
    converted = consts_from_numpy(_as_numpy(jm_packed.consts), device="cpu")
    assert set(converted) == set(tm.consts)
    for k, v in converted.items():
        if isinstance(v, dict):
            assert set(v) == set(tm.consts[k])
            for n in v:
                _assert_close(tm.consts[k][n], v[n], 1e-12)
        elif isinstance(v, float):
            assert v == tm.consts[k]
        else:
            _assert_close(tm.consts[k], v, 1e-12)

    # 5 RK4 steps from the same nonzero state against the JAX reference scan
    monkeypatch.setenv("FUS_PALLAS", "0")
    jm = _jax_model(name, hetero)
    u0, v0 = _state(jm.ops.ndofs)
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    ju, jv, jt = jm.rk(0.0, 5 * DT)
    tm.u_n, tm.v_n = state_from_numpy(u0, v0, device="cpu")
    tu, tv, tt = tm.rk(0.0, 5 * DT)
    assert tt == pytest.approx(float(jt), rel=1e-15)
    _assert_close(tu, ju, 1e-12)
    _assert_close(tv, jv, 1e-12)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_step_matches_unfused(name):
    model = _port_model(name, True)
    u0, v0 = (torch.from_numpy(x) for x in _state(model.ops.ndofs, seed=7))
    fused = make_scan_from_step(model.fused_step())
    unfused = make_scan_from_step(model.unfused_step())
    uf, vf, _ = fused(model.consts, u0, v0, 0.0, 5 * DT, DT)
    ur, vr, _ = unfused(model.consts, u0, v0, 0.0, 5 * DT, DT)
    _assert_close(uf, ur, 1e-12)
    _assert_close(vf, vr, 1e-12)


def _sensor_points(model, on_node):
    """Sensor points [3, n]: lattice nodes (on_node) or points strictly
    inside cells."""
    rng = np.random.default_rng(11)
    if on_node:
        coords = model.ops.dof_coords()
        return coords[rng.choice(len(coords), 9, replace=False)].T
    return np.stack([rng.uniform(0.01, hi - 0.01, 9) for hi in HI])


@pytest.mark.parametrize("on_node", [True, False])
def test_rk_record_matches_jax(on_node, monkeypatch):
    """rk_record of the port (fused step) against the JAX rk_record
    (``FUS_PALLAS=0``): nearest-DOF sensors on nodes, interpolating
    sensors off them."""
    tm = _port_model("focused", True)
    pts = _sensor_points(tm, on_node)
    monkeypatch.setenv("FUS_PALLAS", "0")
    jm = _jax_model("focused", True)
    u0, v0 = _state(jm.ops.ndofs)
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    _, _, jt, jtimes, jys = jm.rk_record(0.0, 5 * DT, pts)
    tm.u_n, tm.v_n = state_from_numpy(u0, v0, device="cpu")
    _, _, tt, times, ys = tm.rk_record(0.0, 5 * DT, pts)
    assert isinstance(ys, torch.Tensor) and ys.shape == (5, 9)
    assert times.dtype == np.float64 and np.array_equal(times, jtimes)
    assert tt == pytest.approx(jt, rel=1e-15)
    _assert_close(ys, jys, 1e-12)


def test_record_plan_takes_nearest_path_only_for_one_hot_rows(monkeypatch):
    model = _port_model("lossy", False)
    calls = []
    for name in ("_sensor_extractor", "_sensor_extractor_interp"):
        orig = getattr(model, name)
        monkeypatch.setattr(model, name, lambda *a, _n=name, _o=orig: calls.append(_n) or _o(*a))
    on = _sensor_points(model, True)
    off = _sensor_points(model, False)
    mixed = np.concatenate([on, off[:, :1]], axis=1)
    u = torch.from_numpy(np.random.default_rng(3).standard_normal(model.ops.ndofs))
    for pts, path in ((on, "_sensor_extractor"), (off, "_sensor_extractor_interp"),
                      (mixed, "_sensor_extractor_interp")):
        rows, wts = model.sensor_interp_tables(pts)
        one_hot = np.all(np.isclose(np.abs(wts).max(axis=1), 1.0))
        assert one_hot == (path == "_sensor_extractor")
        y = model._record_plan(pts)(u)
        assert calls[-1] == path
        _assert_close(y, (u.numpy()[rows] * wts).sum(-1), 1e-14)
    # on nodes, the nearest-DOF indices are the sensors' own nodes
    idx = model.sensor_indices(on)
    np.testing.assert_array_equal(model.ops.dof_coords()[idx].T, on)
