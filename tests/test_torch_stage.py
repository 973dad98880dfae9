"""K2, the fused RK stage of the PyTorch port, against the JAX package's
``FusedRKStageV3._stage_call`` run in Pallas interpret mode (fp64, 1e-12
relative, as ``tests/test_pallas.py``) for every model kind, plus the facet
packing, the host source coefficients and the wrapper's checks.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsxfus_tpu.core.mesh import create_box
from fenicsxfus_tpu.models.common import explicit_tables as jax_tables
from fenicsxfus_tpu.ops.operators import SEMOperators as JaxOps
from fenicsxfus_tpu.ops.pallas_lattice import LatticePallasStiffness
from fenicsxfus_tpu.ops.pallas_stage import source_coefs as jax_source_coefs
from fenicsxfus_tpu.ops.pallas_stage_v3 import FusedRKStageV3
from fenicsxfus_tpu_torch.convert import coeff_from_jax
from fenicsxfus_tpu_torch.ops.stage import (
    KIND_DENSE,
    KIND_FACET,
    KIND_FIELDS,
    FusedRKStage,
    pack_facet_vector,
    source_coefs,
    stage_apply,
    stage_plain,
    unpack_facet_vector,
)

torch.set_num_threads(1)

GRID, HI, P = (6, 4, 4), (1.0, 0.5, 0.5), 3
# [alpha, beta] + source coefficients + final tail [dt·Σb, cu_0..cu_2, db_0..db_3]
SCAL = [0.3, 0.05]
SRC = [1.7, -0.6, 0.9, 0.4]
TAIL = [1.0, 0.02, 0.03, 0.01, 0.15, 0.3, 0.3, 0.15]
KINDS = ("linear", "lossy", "westervelt", "focused")


def _scal(kind, final):
    return SCAL + SRC[: len(KIND_FACET[kind]) - 1] + (TAIL if final else [])


def _facet_field(rng, gdims):
    f = np.zeros(gdims)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        f[sl] = rng.uniform(0.5, 1.5, f[sl].shape)
    return f


def _operands(kind, hetero, seed=0, degree=P):
    """Random K2 operands of ``kind`` on the (6,4,4) lattice of ``degree``
    (p = 3): JAX packed coefficients, state fields, dense extras and packed
    facets (numpy)."""
    jops = JaxOps(create_box(GRID, (0, 0, 0), HI), degree, dtype=jnp.float64)
    pk = LatticePallasStiffness(jops.lattice, interpret=True)
    gd = pk.gdims
    rng = np.random.default_rng(seed)
    Fs = [pk.pack_field(rng.uniform(0.5, 2.0, int(np.prod(GRID)))) if hetero
          else pk.pack_const(rng.uniform(0.5, 2.0)) for _ in range(KIND_FIELDS[kind])]
    f = {n: rng.standard_normal(gd) for n in ("u0", "v0", "kvp", "kvpp", "prev")}
    # inv_m or m0 in [0.5, 1.5]; d2 small enough that m0 − d2·un stays positive
    dense = [rng.uniform(0.5, 1.5, gd) if n != "d2" else rng.uniform(0.0, 0.05, gd)
             for n in KIND_DENSE[kind]]
    pfs = [pack_facet_vector(_facet_field(rng, gd), gd) for _ in KIND_FACET[kind]]
    return pk, Fs, f, dense, pfs


def _torch_args(kind, final, operands, degree=P):
    """``stage_apply`` arguments of the port for ``_operands``' output."""
    _, Fs, f, dense, pfs = operands
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    return dict(
        kind=kind, u0=t["u0"], v0=t["v0"], kvp=t["kvp"], kvpp=t["kvpp"],
        prev=t["prev"] if final else None,
        Fs=[coeff_from_jax({k: np.asarray(v) for k, v in F.items()}, device="cpu") for F in Fs],
        dense=[torch.from_numpy(d) for d in dense],
        facets=[{k: torch.from_numpy(v) for k, v in pf.items()} for pf in pfs],
        scal=_scal(kind, final), p=degree, final=final,
    )


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_stage_v3(kind, hetero, final):
    _check_stage_v3(kind, hetero, final, P)


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_stage_v3_p5(kind, hetero, final):
    """At p = 5, the degree of K2's compiled fp32 tile (csrc/tiles.cuh: PH1
    SC2-BM7's focused run) and of an fp64 one."""
    _check_stage_v3(kind, hetero, final, 5)


def _check_stage_v3(kind, hetero, final, degree):
    operands = _operands(kind, hetero, degree=degree)
    pk, Fs, f, dense, pfs = operands
    got = stage_apply(**_torch_args(kind, final, operands, degree))

    stage = FusedRKStageV3(pk, kind, (hetero,) * len(Fs), jax_tables(4), jnp.float64)
    j = {k: jnp.asarray(v) for k, v in f.items()}
    extras = ([jnp.asarray(d) for d in dense],
              [{k: jnp.asarray(v) for k, v in pf.items()} for pf in pfs])
    ref = stage._stage_call(
        j["u0"], j["v0"], j["kvp"], j["kvpp"], [j["prev"]] if final else [],
        jnp.asarray(_scal(kind, final), jnp.float64).reshape(1, -1), Fs, extras, final=final,
    )
    pairs = zip(got, ref) if final else [(got, ref)]
    for a, b in pairs:
        b = np.asarray(b)
        err = np.max(np.abs(a.numpy() - b))
        assert err < 1e-12 * np.max(np.abs(b)), err


@pytest.mark.parametrize("kind", KINDS)
def test_source_coefs_match_jax(kind):
    consts = {"freq": 0.5e6, "w0": 2 * np.pi * 0.5e6, "p0": 6e4, "s0": 1500.0, "alpha": 4.0}
    for t in (0.0, 1.3e-6, 5e-6, 1.2e-5):
        got = source_coefs(kind, consts, t)
        ref = [float(x) for x in jax_source_coefs(kind, consts, jnp.float64(t))]
        assert len(got) == len(KIND_FACET[kind]) - 1
        np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13 * max(map(abs, ref)))


def test_pack_facet_vector_roundtrip():
    rng = np.random.default_rng(3)
    gd = (7, 5, 6)
    f = _facet_field(rng, gd)
    pf = pack_facet_vector(f, gd)
    assert np.array_equal(unpack_facet_vector({k: torch.from_numpy(v) for k, v in pf.items()}).numpy(), f)
    f[3, 2, 2] = 1.0  # interior support: no packing, the model takes the unfused step
    assert pack_facet_vector(f, gd) is None


def test_stage_wrapper_checks():
    operands = _operands("focused", False)
    args = _torch_args("focused", False, operands)
    t = _torch_args("focused", True, operands)
    before = sum(stage_apply.launches.values())
    assert torch.equal(stage_apply(**args), stage_plain(**args))
    assert sum(stage_apply.launches.values()) == before  # the CPU route launches nothing
    facets = args["facets"]
    for bad in (dict(scal=args["scal"] + [1.0]),                # wrong scal length
                dict(prev=t["prev"]),                           # prev on a non-final stage
                dict(kvp=None),                                 # kvpp without kvp
                dict(dense=[d.float() for d in args["dense"]]),  # dtype mismatch
                dict(facets=facets[:-1]),                       # a facet missing
                dict(Fs=args["Fs"][:1]),                        # one coefficient for two fields
                dict(kind="sponge"),                            # unknown kind
                dict(facets=[{**facets[0], "xp": facets[0]["xp"][:1]}] + facets[1:])):  # bad packing
        with pytest.raises(ValueError):
            stage_apply(**{**args, **bad})
    with pytest.raises(ValueError):
        FusedRKStage((7, 5, 5), 2, "sponge", jax_tables(4))
