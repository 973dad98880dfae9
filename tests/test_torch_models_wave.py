"""The four models of the PyTorch port on the whole-step wavefront
(``FUS_STEP_WAVE=1``: one K3 call per RK4 step) against the JAX package
under the same switch with ``FUS_PALLAS=1`` (its ``FusedRKStepWave`` in
interpret mode): 5 RK4 steps from the same state agree to 1e-12 (fp64).
Linear and lossy in a homogeneous medium take inv_m separable, on both
sides. Also the selection of the step's kernels by the switches, as the JAX
package's ``_try_fused_step`` makes it, and ``FUS_FUSED=0``.
"""

import jax.numpy as jnp
import pytest
import torch

from fenicsxfus_tpu.ops.pallas_step_wave import FusedRKStepWave as JaxStepWave
from fenicsxfus_tpu_torch.convert import state_from_numpy
from fenicsxfus_tpu_torch.models.common import make_scan_from_step
from fenicsxfus_tpu_torch.ops import step_wave, stiffness
from fenicsxfus_tpu_torch.ops.stage import FusedRKStage
from fenicsxfus_tpu_torch.ops.stage_ab import FusedRKStageAB
from fenicsxfus_tpu_torch.ops.step_wave import FusedRKStepWave
from test_torch_models import DT, _assert_close, _media, _mesh, _state
from test_torch_models_ab import CASES

torch.set_num_threads(1)


def _model(name, port, hetero, rk_order=4):
    jax_cls, port_cls, kwargs, tags = CASES[name]
    if port:
        from fenicsxfus_tpu_torch import create_box, tag_boundaries
    else:
        from fenicsxfus_tpu.core.mesh import create_box, tag_boundaries
    mesh = _mesh(create_box, tag_boundaries, tags)
    c0, rho0 = _media(hetero, mesh.num_cells)
    args = dict(meshtags=None, degree=3, c0=c0, rho0=rho0, freq0=0.5e6, p0=6e4, s0=1500.0,
                rk_order=rk_order, dt=DT, **kwargs)
    if port:
        return port_cls(mesh, dtype=torch.float64, device="cpu", **args)
    return jax_cls(mesh, dtype=jnp.float64, **args)


# (model, heterogeneous medium): each model once, linear in both media
MODEL_CASES = [("linear", False), ("linear", True), ("lossy", False), ("westervelt", True),
               ("focused", True)]


@pytest.mark.parametrize("name,hetero", MODEL_CASES)
def test_wave_model_matches_jax(name, hetero, monkeypatch):
    monkeypatch.setenv("FUS_STEP_WAVE", "1")
    monkeypatch.setenv("FUS_PALLAS", "1")
    jax_calls = []
    orig = JaxStepWave._step_call
    monkeypatch.setattr(JaxStepWave, "_step_call",
                        lambda self, *a: jax_calls.append(1) or orig(self, *a))
    jm = _model(name, False, hetero)
    u0, v0 = _state(jm.ops.ndofs)
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    ju, jv, jt = jm.rk(0.0, 5 * DT)
    assert jax_calls, "JAX wave step not taken"  # traced once inside its scan

    calls = []
    orig_plain = step_wave.step_wave_plain
    monkeypatch.setattr(step_wave, "step_wave_plain",
                        lambda *a: calls.append(1) or orig_plain(*a))
    tm = _model(name, True, hetero)
    assert tm.step_kind == "fused" and tm.stage_cls is FusedRKStepWave
    separable = name in ("linear", "lossy") and not hetero
    assert ("inv_m__sep0" in tm.consts) == separable == ("inv_m__sep0" in jm.consts)
    tm.u_n, tm.v_n = state_from_numpy(u0, v0, device="cpu")
    tu, tv, tt = tm.rk(0.0, 5 * DT)
    assert len(calls) == 5  # one whole-step call per step
    assert tt == pytest.approx(float(jt), rel=1e-15)
    _assert_close(tu, ju, 1e-12)
    _assert_close(tv, jv, 1e-12)


# (environment, RK order, the stage class taken; None: the unfused step)
SELECTION = {
    "wave": ({"FUS_STEP_WAVE": "1"}, 4, FusedRKStepWave),
    "wave at rk_order 3": ({"FUS_STEP_WAVE": "1"}, 3, FusedRKStage),
    "wave with FUS_STAGE_V3=0": ({"FUS_STEP_WAVE": "1", "FUS_STAGE_V3": "0"}, 4,
                                 FusedRKStageAB),
    "default": ({}, 4, FusedRKStage),
    "FUS_STEP_WAVE=0": ({"FUS_STEP_WAVE": "0"}, 4, FusedRKStage),
    "FUS_FUSED=0": ({"FUS_FUSED": "0", "FUS_STEP_WAVE": "1"}, 4, None),
}


@pytest.mark.parametrize("case", sorted(SELECTION))
def test_selection(case, monkeypatch):
    env, order, cls = SELECTION[case]
    for k in ("FUS_STEP_WAVE", "FUS_STAGE_V3", "FUS_FUSED", "FUS_V3"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    model = _model("linear", True, False, rk_order=order)
    assert model.stage_cls is cls
    assert model.step_kind == ("unfused" if cls is None else "fused")
    assert ("inv_m__sep0" in model.consts) == (cls is FusedRKStepWave)
    if cls is None:
        assert model.fused_step() is None
        # the unfused step: K1 once per RK stage, as the JAX package's
        # reference scan under FUS_FUSED=0
        calls = []
        orig = stiffness.stiffness_plain
        monkeypatch.setattr(stiffness, "stiffness_plain",
                            lambda *a: calls.append(1) or orig(*a))
        u0, v0 = state_from_numpy(*_state(model.ops.ndofs), device="cpu")
        model.u_n, model.v_n = u0, v0
        u, v, _ = model.rk(0.0, 2 * DT)
        assert len(calls) == 2 * order
        ur, vr, _ = make_scan_from_step(model.unfused_step())(model.consts, u0, v0, 0.0,
                                                              2 * DT, DT)
        assert torch.equal(u, ur) and torch.equal(v, vr)
