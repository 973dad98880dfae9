"""K4a/K4b, the two-kernel lattice stiffness of the PyTorch port, against the
JAX package's two-kernel ``LatticePallasStiffness.apply`` (``FUS_V3=0``,
Pallas interpret mode; fp64, max|Δ| < 1e-12·max|y| as ``tests/test_pallas.py``),
K4a alone against the axis-0 kernel of the JAX two-kernel stage, the
``FUS_V3`` dispatch of ``stiffness_apply`` and the wrappers' checks.

The CUDA kernels themselves are held against the plain versions on the card
by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsxfus_tpu.core.mesh import create_box
from fenicsxfus_tpu.models.common import explicit_tables as jax_tables
from fenicsxfus_tpu.ops.operators import SEMOperators as JaxOps
from fenicsxfus_tpu.ops.pallas_lattice import LatticePallasStiffness
from fenicsxfus_tpu.ops.pallas_stage import FusedRKStage as JaxStageAB
from fenicsxfus_tpu_torch.convert import coeff_from_jax
from fenicsxfus_tpu_torch.ops import stiffness
from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
from fenicsxfus_tpu_torch.ops.stiffness import (
    pack_const,
    pack_field,
    stiffness_apply,
    stiffness_axes12_apply,
    stiffness_axes12_plain,
    stiffness_axis0_apply,
    stiffness_axis0_plain,
    stiffness_plain,
)

torch.set_num_threads(1)

# (grid, degree, coefficient case, fields): the awkward grid of
# tests/test_pallas.py at p = 2, 3, 4 with a constant coefficient, and its
# (6,4,5) p=3 DG-0 cases with one and two fields
CASES = [((9, 5, 7), 2, "const", 1), ((9, 5, 7), 3, "const", 1), ((9, 5, 7), 4, "const", 1),
         ((6, 4, 5), 3, "dg0", 1), ((6, 4, 5), 3, "dg0", 2)]


def _setup(grid, degree, case, n, seed=0):
    """JAX plan, packed coefficients in both layouts, and fields (numpy)."""
    jops = JaxOps(create_box(grid, (0, 0, 0), tuple(0.1 * g for g in grid)), degree,
                  dtype=jnp.float64)
    pk = LatticePallasStiffness(jops.lattice, interpret=True)
    rng = np.random.default_rng(seed)
    if case == "const":
        jFs = [pk.pack_const(c) for c in (1.7, 0.6)[:n]]
    else:
        jFs = [pk.pack_field(rng.uniform(0.5, 2.0, int(np.prod(grid)))) for _ in range(n)]
    tFs = [coeff_from_jax({k: np.asarray(v) for k, v in F.items()}, device="cpu") for F in jFs]
    xs = [rng.standard_normal(pk.gdims) for _ in range(n)]
    return pk, jFs, tFs, xs


def _close(y, y_ref, tol=1e-12):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    err = np.max(np.abs(y - y_ref))
    assert err < tol * np.max(np.abs(y_ref)), err


@pytest.mark.parametrize("grid,degree,case,n", CASES)
def test_plain_composition_matches_two_kernel_apply(grid, degree, case, n, monkeypatch):
    """K4a then K4b (plain) against the JAX two-kernel apply, and against
    the one-kernel plain K1 bit for bit (the axes are added in one order)."""
    pk, jFs, tFs, xs = _setup(grid, degree, case, n)
    monkeypatch.setenv("FUS_V3", "0")
    y_jax = pk.apply([jnp.asarray(x) for x in xs], jFs)
    txs = [torch.from_numpy(x) for x in xs]
    yA = stiffness_axis0_plain(txs, tFs, degree)
    y = stiffness_axes12_plain(txs, tFs, yA, degree)
    assert y is yA  # accumulated in place, as the kernel's aliased output
    _close(y.numpy(), y_jax)
    assert torch.equal(y, stiffness_plain(txs, tFs, degree))


@pytest.mark.parametrize("case", ["const", "dg0"])
@pytest.mark.parametrize("kind", ["linear", "lossy"])
def test_axis0_matches_stage_call_A(kind, case):
    """K4a alone: the JAX two-kernel stage's ``call_A`` with α = β = 0 and no
    slopes is exactly the axis-0 stiffness of (u0[, v0])."""
    n = 1 if kind == "linear" else 2
    pk, jFs, tFs, xs = _setup((6, 4, 5), 3, case, n, seed=1)
    u0, v0 = (np.random.default_rng(2).standard_normal(pk.gdims) for _ in range(2))
    stage = JaxStageAB(pk, kind, (case == "dg0",) * n, jax_tables(4), jnp.float64)
    scal = jnp.zeros((1, 4), jnp.float64)
    y_jax = stage.call_A(jnp.asarray(u0), jnp.asarray(v0), None, None, scal, jFs)
    y = stiffness_axis0_apply([torch.from_numpy(x) for x in (u0, v0)[:n]], tFs, 3)
    _close(y.numpy(), y_jax)


def test_fus_v3_dispatch_takes_the_two_kernel_path(monkeypatch):
    """``stiffness_apply`` reads ``FUS_V3`` at every call: with ``FUS_V3=0``
    it goes through the K4a and K4b wrappers (which on the CPU run their
    plain versions and launch nothing), otherwise through K1's."""
    _, _, tFs, xs = _setup((9, 5, 7), 2, "const", 1)
    x = [torch.from_numpy(xs[0])]
    calls = []
    for name in ("stiffness_axis0_apply", "stiffness_axes12_apply", "stiffness_plain"):
        orig = getattr(stiffness, name)
        monkeypatch.setattr(stiffness, name,
                            lambda *a, _n=name, _o=orig: calls.append(_n) or _o(*a))
    counts = [f.launches for f in (stiffness_apply, stiffness_axis0_apply, stiffness_axes12_apply)]
    monkeypatch.setenv("FUS_V3", "0")
    y = stiffness_apply(x, tFs, 2)
    assert calls == ["stiffness_axis0_apply", "stiffness_axes12_apply"]
    monkeypatch.setenv("FUS_V3", "1")
    assert torch.equal(stiffness_apply(x, tFs, 2), y)
    assert calls[2:] == ["stiffness_plain"]
    monkeypatch.delenv("FUS_V3")
    stiffness_apply(x, tFs, 2)
    assert calls[3:] == ["stiffness_plain"]
    assert counts == [f.launches for f in (stiffness_apply, stiffness_axis0_apply,
                                            stiffness_axes12_apply)]


def test_split_wrapper_checks():
    lat = LatticeStiffness((9, 5, 7), 2, (0.1, 0.1, 0.1), torch.float64)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(lat.gdims))
    F = pack_field(lat, rng.uniform(0.5, 2.0, 315), "cpu")
    yA = stiffness_axis0_apply([x], [F], 2)
    for bad_x, bad_F, p in (([x.float()], [F], 2),                 # dtype mismatch with F
                            ([x], [F], 3),                         # not a degree-3 lattice
                            ([x, x, x], [F, F, F], 2),             # three fields
                            ([x], [{**F, "F2": F["F2"].transpose(1, 2)}], 2)):
        with pytest.raises(ValueError):
            stiffness_axis0_apply(bad_x, bad_F, p)
        with pytest.raises(ValueError):
            stiffness_axes12_apply(bad_x, bad_F, yA.clone(), p)
    for bad_yA in (yA.float(), yA[:-1].contiguous(), yA.transpose(1, 2).contiguous()):
        with pytest.raises(ValueError):
            stiffness_axes12_apply([x], [F], bad_yA, 2)
    # the CPU route launches nothing and leaves yA's input alone in K4a
    assert torch.equal(stiffness_axes12_apply([x], [F], yA.clone(), 2),
                       stiffness_plain([x], [F], 2))
    assert torch.equal(stiffness_axis0_apply([x], [pack_const(lat, 1.0, "cpu")], 2),
                       stiffness_axis0_plain([x], [pack_const(lat, 1.0, "cpu")], 2))
