"""K5b, the second kernel of the two-kernel RK stage of the PyTorch port,
against the JAX package's ``FusedRKStage.call_B`` (``ops/pallas_stage.py``)
run in Pallas interpret mode: fp64, max|Δ| < 1e-12·max|ref|, every model kind
with constant and DG-0 coefficients, at the first stage (no slopes), a middle
stage (two slopes) and the final stage (the step update, with ``prev``).
Operands as ``tests/test_torch_stage.py``'s; K5a against ``call_A`` is
``tests/test_torch_stage_a.py``. Also: K5a then K5b equals K2, and the
wrappers' checks.

The CUDA kernels themselves are held against the plain versions on the card
by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsxfus_tpu.models.common import explicit_tables as jax_tables
from fenicsxfus_tpu.ops.pallas_stage import FusedRKStage as JaxStageAB
from fenicsxfus_tpu_torch.ops.stage import FusedRKStage, stage_plain
from fenicsxfus_tpu_torch.ops.stage_ab import (
    FusedRKStageAB,
    stage_a_apply,
    stage_ab_apply,
    stage_ab_plain,
    stage_b_apply,
)
from test_torch_stage import KINDS, P, _operands, _scal, _torch_args

torch.set_num_threads(1)

SHAPES = ("first", "middle", "final")


def _case(kind, hetero, shape):
    """(JAX stage, JAX operands, port arguments of ``stage_apply``)."""
    operands = _operands(kind, hetero)
    pk, Fs = operands[:2]
    args = _torch_args(kind, shape == "final", operands)
    if shape == "first":
        args.update(kvp=None, kvpp=None)
    stage = JaxStageAB(pk, kind, (hetero,) * len(Fs), jax_tables(4), jnp.float64)
    return stage, operands, args


def _jax(t):
    return None if t is None else jnp.asarray(t.numpy())


def _close(a, b):
    b = np.asarray(b)
    err = np.max(np.abs(a.numpy() - b))
    assert err < 1e-12 * np.max(np.abs(b)), err


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_stage_b_matches_call_B(kind, hetero, shape):
    stage, operands, a = _case(kind, hetero, shape)
    final = shape == "final"
    yA = torch.from_numpy(np.random.default_rng(8).standard_normal(a["u0"].shape))
    scal = jnp.asarray(a["scal"], jnp.float64).reshape(1, -1)
    _, Fs, _, dense, pfs = operands
    extras = ([jnp.asarray(d) for d in dense],
              [{k: jnp.asarray(v) for k, v in pf.items()} for pf in pfs])
    ref = stage.call_B(_jax(a["u0"]), _jax(a["v0"]), _jax(a["kvp"]), _jax(a["kvpp"]),
                       [_jax(a["prev"])] if final else [], _jax(yA), scal, Fs, extras,
                       final=final)
    yA_in = yA.clone()
    got = stage_b_apply(yA=yA_in, **a)
    assert torch.equal(yA_in, yA)  # K5b reads yA and leaves it alone
    for g, r in (zip(got, ref) if final else [(got, ref)]):
        _close(g, r)


@pytest.mark.parametrize("kind", KINDS)
def test_two_kernel_stage_equals_one_kernel_stage(kind):
    """K5a then K5b is K2 split in two: on the same operands the plain
    versions agree bit for bit (the same sums in the same order), and the
    wrappers' CPU route launches nothing."""
    for shape in SHAPES:
        _, _, a = _case(kind, True, shape)
        counts = (dict(stage_a_apply.launches), dict(stage_b_apply.launches))
        ref = stage_plain(**a)
        for got in (stage_ab_apply(**a), stage_ab_plain(**a)):
            for g, r in (zip(got, ref) if a["final"] else [(got, ref)]):
                assert torch.equal(g, r)
        assert counts == (dict(stage_a_apply.launches), dict(stage_b_apply.launches))


def test_stage_ab_wrapper_checks():
    _, _, a = _case("focused", False, "middle")
    _, _, f = _case("focused", False, "final")
    yA = torch.zeros_like(a["u0"])
    bad_b = (dict(scal=a["scal"] + [1.0]),                 # wrong scal length
             dict(prev=f["prev"]),                         # prev on a non-final stage
             dict(kvp=None),                               # kvpp without kvp
             dict(dense=[d.float() for d in a["dense"]]),   # dtype mismatch
             dict(facets=a["facets"][:-1]),                # a facet missing
             dict(yA=yA.float()),                          # yA of another dtype
             dict(yA=yA[1:].contiguous()),                 # yA of another shape
             dict(kind="sponge"))                          # unknown kind
    for bad in bad_b:
        with pytest.raises(ValueError):
            stage_b_apply(**{**a, "yA": yA, **bad})
    a_args = {k: a[k] for k in ("kind", "u0", "v0", "kvp", "kvpp", "Fs", "scal", "p")}
    for bad in (dict(Fs=a["Fs"][:1]),                      # one coefficient for two fields
                dict(kvpp=a["kvpp"].float()),              # dtype mismatch
                dict(scal=[0.3]),                          # no beta
                dict(kind="sponge")):
        with pytest.raises(ValueError):
            stage_a_apply(**{**a_args, **bad})
    # a single-field kind reads no kvp in K5a, as call_A drops it
    _, _, lin = _case("linear", False, "middle")
    got = stage_a_apply("linear", lin["u0"], lin["v0"], None, lin["kvpp"], lin["Fs"],
                        _scal("linear", False), P)
    ref = stage_a_apply("linear", lin["u0"], lin["v0"], lin["kvp"], lin["kvpp"], lin["Fs"],
                        _scal("linear", False), P)
    assert torch.equal(got, ref)
    assert FusedRKStageAB.KERNEL is stage_ab_apply and issubclass(FusedRKStageAB, FusedRKStage)
