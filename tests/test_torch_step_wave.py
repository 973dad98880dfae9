"""K3, the whole-step wavefront of the PyTorch port, against the JAX
package's ``FusedRKStepWave._step_call`` run in Pallas interpret mode (fp64,
1e-12 relative, as ``tests/test_pallas_wave.py``) for every model kind,
constant and DG-0 coefficients, and the separable inv_m of linear and lossy;
plus the host rank-one test of a field, the step's scalar table, and the
wrapper's checks.

On (6,4,4) p=3 the lattice has n0 = 6 axis-0 cells, so the JAX kernel takes
blocks of be = 2 cells and wraps its VMEM rings. The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsxfus_tpu.models.common import explicit_tables as jax_tables
from fenicsxfus_tpu.ops.pallas_step_wave import FusedRKStepWave as JaxStepWave
from fenicsxfus_tpu.ops.pallas_step_wave import try_separate_field as jax_try_separate
from fenicsxfus_tpu_torch.models.common import explicit_tables
from fenicsxfus_tpu_torch.ops.stage import KIND_FACET, KIND_FIELDS, FusedRKStage, stage_plain
from fenicsxfus_tpu_torch.ops.step_wave import (
    FusedRKStepWave,
    step_table,
    step_wave_apply,
    step_wave_plain,
    try_separate_field,
)
from test_torch_stage import GRID, KINDS, P, SRC, _operands, _torch_args

torch.set_num_threads(1)

DT = 0.02  # small enough that m0 − d2·un stays well away from 0


def _scal4(kind):
    """A step table of ``kind`` with distinct source coefficients per stage."""
    nsrc = len(KIND_FACET[kind]) - 1
    srcs = [[x * (1.0 + 0.1 * i) for x in SRC[:nsrc]] for i in range(4)]
    return step_table(kind, explicit_tables(4), DT, srcs)


def _step_operands(kind, hetero, sep, seed=0):
    """The port's and the JAX side's operands of one step: (port arguments
    of ``step_wave_apply``, JAX packed coefficients and extras)."""
    operands = _operands(kind, hetero, seed)
    pk, Fs, f, dense, pfs = operands
    args = _torch_args(kind, False, operands)
    if sep:  # inv_m = a[g0] · P[g1, g2]
        rng = np.random.default_rng(seed + 100)
        G0, G1, G2 = pk.gdims
        dense = [rng.uniform(0.5, 1.5, G0), rng.uniform(0.5, 1.5, (1, G1, G2))]
    port = dict(kind=kind, u0=args["u0"], v0=args["v0"], scal4=_scal4(kind), Fs=args["Fs"],
                dense=[torch.from_numpy(d) for d in dense], facets=args["facets"], p=P)
    extras = ([jnp.asarray(d) for d in dense],
              [{k: jnp.asarray(v) for k, v in pf.items()} for pf in pfs])
    return port, pk, Fs, f, extras


CASES = [(kind, hetero, False) for kind in KINDS for hetero in (False, True)]
CASES += [("linear", False, True), ("lossy", True, True)]


@pytest.mark.parametrize("kind,hetero,sep", CASES)
def test_step_wave_matches_jax(kind, hetero, sep):
    port, pk, Fs, f, extras = _step_operands(kind, hetero, sep)
    before = sum(step_wave_apply.launches.values())
    u1, v1 = step_wave_apply(**port)
    assert sum(step_wave_apply.launches.values()) == before  # the CPU route launches nothing

    wave = JaxStepWave(pk, kind, (hetero,) * KIND_FIELDS[kind], jax_tables(4), jnp.float64)
    wave.sep_invm = sep
    assert wave.usable()
    ju1, jv1 = wave._step_call(jnp.asarray(f["u0"]), jnp.asarray(f["v0"]),
                               jnp.asarray(port["scal4"]), Fs, extras)
    for a, b in ((u1, ju1), (v1, jv1)):
        b = np.asarray(b).reshape(a.shape)
        err = np.max(np.abs(a.numpy() - b))
        assert err < 1e-12 * np.max(np.abs(b)), err


def _separable_cases():
    """(name, field, gdims) of the rank-one test, as
    ``tests/test_pallas_wave.py::test_separate_field_dtype_scaled_tol``, and
    the edge cases of the test itself."""
    rng = np.random.default_rng(7)
    a = rng.random(17) + 1.0
    P_ = rng.random((9, 9)) + 1.0
    M64 = a[:, None, None] * P_[None]
    M32 = M64.astype(np.float32)
    gd = (17, 9, 9)
    bad = M64.copy()
    bad[3, 4, 5] = np.nan
    return {
        "fp32 rank one": (M32, gd),
        "fp64 rank one": (M64, gd),
        "fp32 perturbed": (M32 * (1.0 + 1e-4 * rng.standard_normal(M32.shape)).astype(
            np.float32), gd),
        "fp64 perturbed": (M64 * (1.0 + 1e-10 * rng.standard_normal(M64.shape)), gd),
        "not finite": (bad, gd),
        "zero": (np.zeros(gd), gd),
        "signed rank one": (-M64 * np.sign(rng.standard_normal(17))[:, None, None], gd),
    }


SEPARABLE = _separable_cases()
SEPARABLE_EXPECT = {"fp32 rank one": True, "fp64 rank one": True, "fp32 perturbed": False,
                    "fp64 perturbed": False, "not finite": False, "zero": False,
                    "signed rank one": True}


@pytest.mark.parametrize("name", sorted(SEPARABLE))
def test_try_separate_field_matches_jax(name):
    field, gd = SEPARABLE[name]
    got, ref = try_separate_field(field, gd), jax_try_separate(field, gd)
    assert (got is not None) == SEPARABLE_EXPECT[name]
    assert (ref is None) == (got is None)
    if got is not None:
        assert got[0].shape == (gd[0],) and got[1].shape == (1,) + gd[1:]
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
        rec = got[0][:, None, None] * got[1]
        scale = np.max(np.abs(field))
        eps = np.finfo(field.dtype).eps
        assert np.max(np.abs(rec - field.astype(np.float64))) < 100 * eps * scale


@pytest.mark.parametrize("kind", KINDS)
def test_wave_step_equals_four_plain_stages(kind):
    """``FusedRKStepWave.make_step`` on ``step_wave_plain`` equals the K2
    step (``FusedRKStage``) on ``stage_plain``, bit for bit: the same scalars
    (sources at the stage times included) and the same four stages."""
    port, *_ = _step_operands(kind, True, False)
    consts = {"freq": 0.5e6, "w0": 2 * np.pi * 0.5e6, "p0": 1.0, "s0": 1500.0, "alpha": 4.0}
    tables = explicit_tables(4)
    to_Fs = lambda c: port["Fs"]  # noqa: E731
    to_extras = lambda c: (port["dense"], port["facets"])  # noqa: E731
    wave = FusedRKStepWave(GRID, P, kind, tables).make_step(to_Fs, to_extras,
                                                            stage_fn=step_wave_plain)
    k2 = FusedRKStage(GRID, P, kind, tables).make_step(to_Fs, to_extras, stage_fn=stage_plain)
    carry = (port["u0"], port["v0"], 1.3e-6)
    got, ref = wave(consts, carry, 1e-8), k2(consts, carry, 1e-8)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[2] == ref[2]
    assert wave.carry_shape == GRID


def test_step_wave_wrapper_checks():
    port, *_ = _step_operands("lossy", False, False)
    sep, *_ = _step_operands("lossy", False, True)
    focused, *_ = _step_operands("focused", False, False)
    assert torch.equal(step_wave_apply(**sep)[0], step_wave_plain(**sep)[0])
    facets = port["facets"]
    for args, bad in ((port, dict(scal4=port["scal4"][:, :-1])),          # wrong table width
                      (port, dict(scal4=port["scal4"][:3])),              # three stages
                      (port, dict(dense=port["dense"] * 3)),              # three dense fields
                      (port, dict(dense=[d.float() for d in port["dense"]])),  # dtype mismatch
                      (sep, dict(dense=[sep["dense"][0][:-1], sep["dense"][1]])),  # bad a
                      (sep, dict(dense=[sep["dense"][0], sep["dense"][1][0]])),    # bad P
                      (focused, dict(dense=focused["dense"][:1])),        # m0 without d2
                      (port, dict(facets=facets[:-1])),                   # a facet missing
                      (port, dict(Fs=port["Fs"][:1])),                    # one coefficient
                      (port, dict(kind="sponge")),                        # unknown kind
                      (port, dict(grid=-1)),                              # negative grid
                      (port, dict(grid=1.5))):                            # fractional grid
        with pytest.raises(ValueError):
            step_wave_apply(**{**args, **bad})
    three = FusedRKStepWave(GRID, P, "linear", explicit_tables(3))
    assert not three.usable()
    with pytest.raises(ValueError):
        three.make_step(lambda c: [], lambda c: ([], []))
