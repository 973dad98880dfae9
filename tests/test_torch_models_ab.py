"""The four models of the PyTorch port on the two-kernel pipeline
(``FUS_STAGE_V3=0``: K5a then K5b per RK stage; ``FUS_V3=0``: K4a then K4b
per stiffness apply) against the JAX package under the same switches with
``FUS_PALLAS=1`` (its two-kernel Pallas stage in interpret mode): 5 RK4 steps
from the same state in a heterogeneous medium agree to 1e-12 (fp64), for the
fused step and for the unfused step, and each goes through the two-kernel
wrappers only. Models and media as ``tests/test_torch_models.py``.
"""

import jax.numpy as jnp
import pytest
import torch

from fenicsxfus_tpu.core.mesh import create_box as jax_create_box
from fenicsxfus_tpu.core.mesh import tag_boundaries as jax_tag_boundaries
from fenicsxfus_tpu.models.linear import LinearSpectralExplicit as JaxLinear
from fenicsxfus_tpu_torch import LinearSpectralExplicit, create_box, tag_boundaries
from fenicsxfus_tpu_torch.convert import state_from_numpy
from fenicsxfus_tpu_torch.models.common import make_scan_from_step
from fenicsxfus_tpu_torch.ops import stage, stage_ab, stiffness
from test_torch_models import DT, MODELS, _assert_close, _media, _mesh, _state

torch.set_num_threads(1)

CASES = {**MODELS, "linear": (JaxLinear, LinearSpectralExplicit, {}, "ends")}


def _model(name, port):
    jax_cls, port_cls, kwargs, tags = CASES[name]
    mesh = _mesh(create_box, tag_boundaries, tags) if port else \
        _mesh(jax_create_box, jax_tag_boundaries, tags)
    c0, rho0 = _media(True, mesh.num_cells)
    args = dict(meshtags=None, degree=3, c0=c0, rho0=rho0, freq0=0.5e6, p0=6e4, s0=1500.0,
                rk_order=4, dt=DT, **kwargs)
    if port:
        return port_cls(mesh, dtype=torch.float64, device="cpu", **args)
    return jax_cls(mesh, dtype=jnp.float64, **args)


def _spy(monkeypatch, module, name, calls):
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(name) or orig(*a))


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_kernel_model_matches_jax(name, monkeypatch):
    monkeypatch.setenv("FUS_STAGE_V3", "0")
    monkeypatch.setenv("FUS_V3", "0")
    monkeypatch.setenv("FUS_PALLAS", "1")
    jm = _model(name, port=False)
    assert jm._try_build_fused() is not None, "JAX fused path not taken"
    u0, v0 = _state(jm.ops.ndofs)
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    ju, jv, jt = jm.rk(0.0, 5 * DT)

    calls = []
    for mod, fn in ((stage_ab, "stage_a_apply"), (stage_ab, "stage_b_apply"),
                    (stiffness, "stiffness_axis0_apply"), (stiffness, "stiffness_axes12_apply"),
                    (stage, "stage_plain"), (stiffness, "stiffness_plain")):
        _spy(monkeypatch, mod, fn, calls)
    tm = _model(name, port=True)
    assert tm.step_kind == "fused"
    tm.u_n, tm.v_n = state_from_numpy(u0, v0, device="cpu")
    tu, tv, tt = tm.rk(0.0, 5 * DT)
    assert tt == pytest.approx(float(jt), rel=1e-15)
    _assert_close(tu, ju, 1e-12)
    _assert_close(tv, jv, 1e-12)
    # one K5a and one K5b call per stage, and nothing of K2 or K1
    assert sorted(set(calls)) == ["stage_a_apply", "stage_b_apply"]
    assert calls.count("stage_a_apply") == calls.count("stage_b_apply") == 20

    # the unfused step: one K4a and one K4b call per stage
    calls.clear()
    x0, y0 = state_from_numpy(u0, v0, device="cpu")
    uu, vu, _ = make_scan_from_step(tm.unfused_step())(tm.consts, x0, y0, 0.0, 5 * DT, DT)
    _assert_close(uu, ju, 1e-12)
    _assert_close(vu, jv, 1e-12)
    assert sorted(set(calls)) == ["stiffness_axes12_apply", "stiffness_axis0_apply"]
    assert calls.count("stiffness_axis0_apply") == 20
