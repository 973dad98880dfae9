"""The port's CUDA kernels on the card, against their plain torch twins.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports no jax, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py

fp64 cases hold the kernels to 1e-12 relative (the same sums in another
order); fp32 cases to 1e-5 (``chip_smoke.py``'s tolerance).
"""

import numpy as np
import pytest
import torch

from fenicsxfus_tpu_torch import (
    LinearSpectralExplicit,
    WesterveltSpectralFocused,
    create_box,
    tag_boundaries,
)
from fenicsxfus_tpu_torch.convert import state_from_numpy
from fenicsxfus_tpu_torch.models.common import explicit_tables, make_scan_from_step
from fenicsxfus_tpu_torch.ops import stage, stage_ab, stiffness, step_wave
from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
from fenicsxfus_tpu_torch.ops.stage import (
    KIND_DENSE,
    KIND_FACET,
    KIND_FIELDS,
    pack_facet_vector,
    stage_apply,
    stage_plain,
)
from fenicsxfus_tpu_torch.ops.stage_ab import (
    stage_a_apply,
    stage_a_plain,
    stage_b_apply,
    stage_b_plain,
)
from fenicsxfus_tpu_torch.ops.step_wave import (
    FusedRKStepWave,
    step_table,
    step_wave_apply,
    step_wave_check,
    step_wave_plain,
)
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

pytestmark = pytest.mark.gpu

GRID = (9, 5, 7)
# (5, 1, 1): one cell across y and z, as the channel runs of chip_smoke.py,
# so every node lies on two facet planes and the stencil folds on itself
GRIDS = [GRID, (5, 1, 1)]
TOLS = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("degree", [2, 3, 4])
@pytest.mark.parametrize("grid", GRIDS)
def test_k1_matches_plain(grid, degree, dtype, cuda):
    lat = LatticeStiffness(grid, degree, (0.1, 0.14, 0.07), dtype)
    rng = np.random.default_rng(degree)
    Fs = [pack_const(lat, 1.7, cuda),
          pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(grid))), cuda)]
    xs = [torch.as_tensor(rng.standard_normal(lat.gdims), dtype=dtype, device=cuda)
          for _ in range(2)]
    for x_in, F_in in (([xs[0]], Fs[:1]), ([xs[1]], Fs[1:]), (xs, Fs)):
        before = stiffness_apply.launches
        y = stiffness_apply(x_in, F_in, degree)
        assert stiffness_apply.launches == before + 1
        assert _rel(y, stiffness_plain(x_in, F_in, degree)) < TOLS[dtype]


def _stage_args(kind, lat, rng, device, present, final, dg0):
    gd = lat.gdims
    dt = lat.dtype

    def field():
        return torch.as_tensor(rng.standard_normal(gd), dtype=dt, device=device)

    def facets():
        f = np.zeros(gd)
        for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
            f[sl] = rng.uniform(0.5, 1.5, f[sl].shape)
        return {k: torch.as_tensor(v, dtype=dt, device=device)
                for k, v in pack_facet_vector(f, gd).items()}

    kvp, kvpp, prev = (field() if p else None for p in present)
    ns = 1 + sum(present)
    nfa = len(KIND_FACET[kind])
    scal = [0.3, 0.05] + list(rng.uniform(-2.0, 2.0, nfa - 1))
    scal += list(rng.uniform(0.01, 1.0, 2 * ns)) if final else []
    ncells = int(np.prod(lat.grid))
    Fs = [pack_field(lat, rng.uniform(0.5, 2.0, ncells), device) if dg0 and f == 0
          else pack_const(lat, 1.7 - 0.5 * f, device) for f in range(KIND_FIELDS[kind])]
    dense = [torch.as_tensor(rng.uniform(0.0, 0.05, gd) if n == "d2" else rng.uniform(0.5, 1.5, gd),
                             dtype=dt, device=device) for n in KIND_DENSE[kind]]
    return (kind, field(), field(), kvp, kvpp, prev, Fs, dense,
            [facets() for _ in range(nfa)], scal, lat.p, final)


# (kvp, kvpp, prev) present, final: every stage shape of the RK1-RK4 tables
STAGES = [((0, 0, 0), False), ((1, 0, 0), False), ((1, 1, 0), False),
          ((0, 0, 0), True), ((1, 0, 0), True), ((1, 1, 0), True), ((1, 1, 1), True)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("present,final", STAGES)
@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
@pytest.mark.parametrize("grid", GRIDS)
def test_k2_matches_plain(grid, kind, present, final, dtype, cuda):
    lat = LatticeStiffness(grid, 4, (0.1, 0.14, 0.07), dtype)
    rng = np.random.default_rng(sum(present) + 4 * final)
    for dg0 in (False, True):
        args = _stage_args(kind, lat, rng, cuda, present, final, dg0)
        before = stage_apply.launches[kind]
        got = stage_apply(*args)
        assert stage_apply.launches[kind] == before + 1
        ref = stage_plain(*args)
        for a, b in (zip(got, ref) if final else [(got, ref)]):
            assert _rel(a, b) < TOLS[dtype]


# the tiled K1/K2 (csrc/tile.cuh): a lattice no tile divides and a channel
# one cell across, on unit cells with O(1) coefficients (the stiffness term
# as large as the rest, so a stencil fault shows), under the default plan
# and under the main path's tile and slab (the minimum block count set to 1);
# K1's and K2's also on "compiled", the lattice of two whole and one cut
# compiled tile along g1 and g2 (csrc/tiles.cuh), 16 cells along g0, at the
# degree and type
TILE_GRIDS = [(13, 11, 17), (41, 1, 1)]
COMPILED_GRIDS = TILE_GRIDS + ["compiled"]
PLANS = ["default", "main-path tile"]


def _use_plan(plan, monkeypatch):
    if plan == "main-path tile":
        monkeypatch.setattr(stiffness, "MIN_BLOCKS", 1)


def _tile_grid(grid, degree, dtype, family):
    """``grid``, or for "compiled" the cut-tile lattice of the widest
    compiled tile of ``family`` ("K1", "K2", "K2+band") at the degree and
    type ((13, 11, 17) where it has none); and whether the launches there
    must take a compiled tile."""
    if grid != "compiled":
        return grid, False
    dtn = str(dtype).split(".")[-1]
    keys = [k for k in stiffness.COMPILED_TILES if k[:3] == (family, dtn, degree)]
    if not keys:
        return (13, 11, 17), False
    tiles = []
    for fam, _, p, what in keys:
        nf = what if fam == "K1" else KIND_FIELDS[what]
        nr = nf if fam == "K1" else stiffness.KIND_RAW[nf]
        tiles.append(stiffness.degree_tile(p, nf, nr, stiffness.ITEMSIZE[dtype]))
    return (16, 2 * max(t[0] for t in tiles) // degree + 1,
            2 * max(t[1] for t in tiles) // degree + 1), True


def _took(counter, before):
    """The kernels (``ops/stiffness.py::tile_kernel``) launched since ``before``."""
    return [k for k, v in counter.items() if v != before.get(k, 0)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("degree", range(1, 9))
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("grid", COMPILED_GRIDS)
def test_tiled_k1_matches_plain(grid, plan, degree, dtype, cuda, monkeypatch):
    _use_plan(plan, monkeypatch)
    grid, compiled = _tile_grid(grid, degree, dtype, "K1")
    lat = LatticeStiffness(grid, degree, (1.0, 1.0, 1.0), dtype)
    rng = np.random.default_rng(degree)
    Fs = [pack_const(lat, 1.7, cuda),
          pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(grid))), cuda)]
    xs = [torch.as_tensor(rng.standard_normal(lat.gdims), dtype=dtype, device=cuda)
          for _ in range(2)]
    for x_in, F_in in (([xs[0]], Fs[:1]), ([xs[1]], Fs[1:]), (xs, Fs), (xs, Fs[::-1])):
        before, tiles = stiffness_apply.launches, dict(stiffness_apply.tiles)
        y = stiffness_apply(x_in, F_in, degree)
        assert stiffness_apply.launches == before + 1
        assert _rel(y, stiffness_plain(x_in, F_in, degree)) < TOLS[dtype]
        took = _took(stiffness_apply.tiles, tiles)
        assert len(took) == 1 and (not compiled or took[0].endswith("compiled")), took


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("degree", range(1, 9))
@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("grid", COMPILED_GRIDS)
def test_tiled_k2_matches_plain(grid, plan, kind, degree, dtype, cuda, monkeypatch):
    _use_plan(plan, monkeypatch)
    grid, compiled = _tile_grid(grid, degree, dtype, "K2")
    compiled &= stiffness.compiled_key(degree, dtype, ("K2", kind)) is not None
    lat = LatticeStiffness(grid, degree, (1.0, 1.0, 1.0), dtype)
    rng = np.random.default_rng(degree + 10 * len(kind))
    for (present, final), dg0 in ((STAGES[2], False), (STAGES[2], True),
                                  (STAGES[6], False), (STAGES[6], True)):
        args = _stage_args(kind, lat, rng, cuda, present, final, dg0)
        before, tiles = stage_apply.launches[kind], dict(stage_apply.tiles)
        got = stage_apply(*args)
        assert stage_apply.launches[kind] == before + 1
        took = _took(stage_apply.tiles, tiles)
        assert len(took) == 1 and (not compiled or took[0].endswith("compiled")), took
        ref = stage_plain(*args)
        for a, b in (zip(got, ref) if final else [(got, ref)]):
            assert _rel(a, b) < TOLS[dtype]


# (9, 5, 7) cells run the general tile kernel; (6, 4, 16) at p = 4 in fp32,
# under the main path's tile, the compile-time 8 x 32 one
EQUAL_GRIDS = [(GRID, "default"), ((6, 4, 16), "main-path tile")]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
@pytest.mark.parametrize("grid,plan", EQUAL_GRIDS)
def test_split_and_wave_equal_tiled_k2_bit_for_bit(grid, plan, kind, dtype, cuda, monkeypatch):
    """Every kernel rounds the per-node arithmetic alike (lattice.cuh's
    written-out roundings): K5a -> K5b equals the tiled K2 and K3 equals
    four tiled K2 launches bit for bit, and K4a -> K4b on the stage's
    fields and coefficients equals the tiled K1."""
    _use_plan(plan, monkeypatch)
    lat = LatticeStiffness(grid, 4, (1.0, 1.0, 1.0), dtype)
    rng = np.random.default_rng(len(kind) + 7)
    for dg0 in (False, True):
        for present, final in (STAGES[2], STAGES[6]):
            args = _stage_args(kind, lat, rng, cuda, present, final, dg0)
            _, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, _ = args
            yA = stage_a_apply(kind, u0, v0, kvp, kvpp, Fs, scal, p)
            split = stage_b_apply(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p,
                                  final)
            whole = stage_apply(*args)
            for a, b in (zip(split, whole) if final else [(split, whole)]):
                assert torch.equal(a, b)
        wave = _wave_args(kind, lat, rng, cuda, dg0, False)
        got = step_wave_apply(**wave)
        k2 = step_wave_plain(**wave, stage_fn=stage_apply)
        step_wave_check()
        assert torch.equal(got[0], k2[0]) and torch.equal(got[1], k2[1])
        x = [u0, v0]
        for xs, F in ((x[:1], Fs[:1]), (x, [Fs[0], Fs[-1]])):
            y = stiffness_axes12_apply(xs, F, stiffness_axis0_apply(xs, F, 4), 4)
            assert torch.equal(y, stiffness_apply(xs, F, 4))


def test_refused_plan_raises(cuda, monkeypatch):
    """A plan the card refuses (more shared memory than a block may have) or
    that the C entry refuses (a grid that leaves nodes without an owner)
    raises, counts no launch, and leaves the next launch right."""
    lat = LatticeStiffness(GRID, 4, (1.0, 1.0, 1.0), torch.float32)
    args = _stage_args("focused", lat, np.random.default_rng(5), cuda, (1, 1, 0), False, True)
    x, F = args[1], args[6][0]
    plan = stiffness.tile_plan
    for bad in ({"smem": stiffness.SMEM_MAX + 8192}, {"grid": (1, 1, 1)}):
        monkeypatch.setattr(stiffness, "tile_plan", lambda *a, **k: dict(plan(*a, **k), **bad))
        monkeypatch.setattr(stage, "tile_plan", stiffness.tile_plan)
        k1, k2 = stiffness_apply.launches, stage_apply.launches["focused"]
        with pytest.raises(RuntimeError, match="launch failed"):
            stiffness_apply([x], [F], 4)
        with pytest.raises(RuntimeError, match="launch failed"):
            stage_apply(*args)
        assert (stiffness_apply.launches, stage_apply.launches["focused"]) == (k1, k2)
        monkeypatch.undo()
        assert _rel(stiffness_apply([x], [F], 4), stiffness_plain([x], [F], 4)) < 1e-5
        assert _rel(stage_apply(*args), stage_plain(*args)) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("degree", [2, 3, 4])
@pytest.mark.parametrize("grid", GRIDS)
def test_k4_matches_plain(grid, degree, dtype, cuda, monkeypatch):
    """K4a, K4b and their composition against the plain versions, and the
    ``FUS_V3=0`` dispatch of ``stiffness_apply`` through K4a and K4b."""
    lat = LatticeStiffness(grid, degree, (0.1, 0.14, 0.07), dtype)
    rng = np.random.default_rng(degree)
    Fs = [pack_const(lat, 1.7, cuda),
          pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(grid))), cuda)]
    xs = [torch.as_tensor(rng.standard_normal(lat.gdims), dtype=dtype, device=cuda)
          for _ in range(2)]
    for x_in, F_in in (([xs[0]], Fs[:1]), ([xs[1]], Fs[1:]), (xs, Fs)):
        before = stiffness_axis0_apply.launches, stiffness_axes12_apply.launches
        yA = stiffness_axis0_apply(x_in, F_in, degree)
        assert _rel(yA, stiffness_axis0_plain(x_in, F_in, degree)) < TOLS[dtype]
        y = stiffness_axes12_apply(x_in, F_in, yA.clone(), degree)
        assert _rel(y, stiffness_axes12_plain(x_in, F_in, yA.clone(), degree)) < TOLS[dtype]
        assert _rel(y, stiffness_plain(x_in, F_in, degree)) < TOLS[dtype]
        assert (stiffness_axis0_apply.launches, stiffness_axes12_apply.launches) == (
            before[0] + 1, before[1] + 1)
    monkeypatch.setenv("FUS_V3", "0")
    k1, k4a, k4b = (stiffness_apply.launches, stiffness_axis0_apply.launches,
                    stiffness_axes12_apply.launches)
    y = stiffness_apply(xs, Fs, degree)
    assert (stiffness_apply.launches, stiffness_axis0_apply.launches,
            stiffness_axes12_apply.launches) == (k1, k4a + 1, k4b + 1)
    assert _rel(y, stiffness_plain(xs, Fs, degree)) < TOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("present,final", STAGES)
@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
@pytest.mark.parametrize("grid", GRIDS)
def test_k5_matches_plain(grid, kind, present, final, dtype, cuda):
    """K5a and K5b against their plain versions (K5b on K5a's output), and
    the pair against the one-kernel stage's plain version."""
    lat = LatticeStiffness(grid, 4, (0.1, 0.14, 0.07), dtype)
    rng = np.random.default_rng(sum(present) + 4 * final)
    for dg0 in (False, True):
        args = _stage_args(kind, lat, rng, cuda, present, final, dg0)
        _, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, _ = args
        before = stage_a_apply.launches[kind], stage_b_apply.launches[kind]
        yA = stage_a_apply(kind, u0, v0, kvp, kvpp, Fs, scal, p)
        assert _rel(yA, stage_a_plain(kind, u0, v0, kvp, kvpp, Fs, scal, p)) < TOLS[dtype]
        got = stage_b_apply(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p, final)
        assert (stage_a_apply.launches[kind], stage_b_apply.launches[kind]) == (
            before[0] + 1, before[1] + 1)
        ref = stage_b_plain(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p, final)
        whole = stage_plain(*args)
        for a, b, c in (zip(got, ref, whole) if final else [(got, ref, whole)]):
            assert _rel(a, b) < TOLS[dtype]
            assert _rel(a, c) < TOLS[dtype]


# K5a's column march (csrc/column.cuh) and K5b's plane tile (csrc/plane.cuh)
# at p = 1..8: the small lattice of the tests above, a lattice no tile
# divides, unit cells that the main path's fp32 p = 4 tile fits, and a
# channel one cell across; under the default plans, the main path's (the
# minimum block count set to 1, so the starting sizes stay) and small
# general plans (many blocks, short slabs and runs, a tile of one or two
# cells)
SPLIT_GRIDS = [(GRID, (0.1, 0.14, 0.07)), ((13, 11, 17), (1.0, 1.0, 1.0)),
               ((6, 4, 16), (1.0, 1.0, 1.0)), ((41, 1, 1), (1.0, 1.0, 1.0))]
SPLIT_PLANS = ["default", "main-path", "general"]


def _use_split_plan(plan, monkeypatch):
    """The walks' plans (ops/stiffness.py::column_plan, plane_plan, which K4
    and K5 share) at ``plan``'s sizes."""
    if plan != "default":
        monkeypatch.setattr(stiffness, "MIN_BLOCKS", 1)
    if plan == "general":
        monkeypatch.setattr(stiffness, "COLUMN_THREADS", 64)
        monkeypatch.setattr(stiffness, "COLUMN_SLAB", 3)
        monkeypatch.setattr(stiffness, "PLANE_TILE", (8, 16))
        monkeypatch.setattr(stiffness, "PLANE_RUN", 3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("degree", range(1, 9))
@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
@pytest.mark.parametrize("plan", SPLIT_PLANS)
@pytest.mark.parametrize("grid,h", SPLIT_GRIDS)
def test_k5_walks_match_plain(grid, h, plan, kind, degree, dtype, cuda, monkeypatch):
    """K5a and K5b against their plain versions (K5b on K5a's output) for a
    middle and a final stage, constant and DG-0 coefficients."""
    _use_split_plan(plan, monkeypatch)
    lat = LatticeStiffness(grid, degree, h, dtype)
    rng = np.random.default_rng(degree + 10 * len(kind))
    for (present, final), dg0 in ((STAGES[2], False), (STAGES[6], True)):
        args = _stage_args(kind, lat, rng, cuda, present, final, dg0)
        _, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, _ = args
        before = stage_a_apply.launches[kind], stage_b_apply.launches[kind]
        yA = stage_a_apply(kind, u0, v0, kvp, kvpp, Fs, scal, p)
        assert _rel(yA, stage_a_plain(kind, u0, v0, kvp, kvpp, Fs, scal, p)) < TOLS[dtype]
        got = stage_b_apply(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p, final)
        assert (stage_a_apply.launches[kind], stage_b_apply.launches[kind]) == (
            before[0] + 1, before[1] + 1)
        ref = stage_b_plain(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p, final)
        for a, b in (zip(got, ref) if final else [(got, ref)]):
            assert _rel(a, b) < TOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("degree", range(1, 9))
@pytest.mark.parametrize("plan", SPLIT_PLANS)
@pytest.mark.parametrize("grid,h", SPLIT_GRIDS)
def test_k4_walks_match_plain(grid, h, plan, degree, dtype, cuda, monkeypatch):
    """K4a (the column march) and K4b (the plane tile, in place over yA)
    against their plain versions, and K4a -> K4b equal to the tiled K1 bit
    for bit: one field with a constant and with a DG-0 coefficient, and two
    fields, on the walks' lattices and plans."""
    _use_split_plan(plan, monkeypatch)
    lat = LatticeStiffness(grid, degree, h, dtype)
    rng = np.random.default_rng(degree + 30)
    Fs = [pack_const(lat, 1.7, cuda),
          pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(grid))), cuda)]
    xs = [torch.as_tensor(rng.standard_normal(lat.gdims), dtype=dtype, device=cuda)
          for _ in range(2)]
    for x_in, F_in in (([xs[0]], Fs[:1]), ([xs[1]], Fs[1:]), (xs, Fs)):
        before = stiffness_axis0_apply.launches, stiffness_axes12_apply.launches
        yA = stiffness_axis0_apply(x_in, F_in, degree)
        assert _rel(yA, stiffness_axis0_plain(x_in, F_in, degree)) < TOLS[dtype]
        ref = stiffness_axes12_plain(x_in, F_in, yA.clone(), degree)
        y = stiffness_axes12_apply(x_in, F_in, yA, degree)
        assert y.data_ptr() == yA.data_ptr()  # in place, as the TPU kernel aliases it
        assert (stiffness_axis0_apply.launches, stiffness_axes12_apply.launches) == (
            before[0] + 1, before[1] + 1)
        assert _rel(y, ref) < TOLS[dtype]
        assert torch.equal(y, stiffness_apply(x_in, F_in, degree))


def test_k4_refused_plan_raises(cuda, monkeypatch):
    """A K4a plan the C entry refuses (a grid that leaves columns or cells
    without an owner) and K4b plans the C entry or the card refuses (a grid
    short of the planes, more shared memory than a block may have) raise,
    count no launch, write nothing, and leave the next launch right."""
    lat = LatticeStiffness(GRID, 4, (1.0, 1.0, 1.0), torch.float32)
    rng = np.random.default_rng(5)
    F = pack_field(lat, rng.uniform(0.5, 2.0, int(np.prod(GRID))), cuda)
    x = torch.as_tensor(rng.standard_normal(lat.gdims), dtype=torch.float32, device=cuda)
    yA = stiffness_axis0_apply([x], [F], 4)
    column, plane = stiffness.column_plan, stiffness.plane_plan
    for bad in ({"grid": (1, 1)}, {"columns": 64}):
        monkeypatch.setattr(stiffness, "column_plan",
                            lambda *a, **k: dict(column(*a, **k), **bad))
        before = stiffness_axis0_apply.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            stiffness_axis0_apply([x], [F], 4)
        assert stiffness_axis0_apply.launches == before
        monkeypatch.undo()
    for bad in ({"grid": (1, 1, 1)}, {"smem": stiffness.SMEM_MAX + 8192}):
        monkeypatch.setattr(stiffness, "plane_plan", lambda *a, **k: dict(plane(*a, **k), **bad))
        before = stiffness_axes12_apply.launches
        y = yA.clone()
        with pytest.raises(RuntimeError, match="launch failed"):
            stiffness_axes12_apply([x], [F], y, 4)
        torch.cuda.synchronize()
        assert stiffness_axes12_apply.launches == before and torch.equal(y, yA)
        monkeypatch.undo()
    y = stiffness_axes12_apply([x], [F], stiffness_axis0_apply([x], [F], 4), 4)
    assert _rel(y, stiffness_plain([x], [F], 4)) < 1e-5


def test_k5_refused_plan_raises(cuda, monkeypatch):
    """A K5a plan the C entry refuses (a grid that leaves columns or cells
    without an owner) and K5b plans the C entry or the card refuses (a grid
    short of the planes, more shared memory than a block may have) raise,
    count no launch, and leave the next launch right."""
    lat = LatticeStiffness(GRID, 4, (1.0, 1.0, 1.0), torch.float32)
    args = _stage_args("focused", lat, np.random.default_rng(5), cuda, (1, 1, 0), False, True)
    _, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final = args
    yA = stage_a_apply("focused", u0, v0, kvp, kvpp, Fs, scal, p)
    column, plane = stage_ab.column_plan, stage_ab.plane_plan
    for bad in ({"grid": (1, 1)}, {"columns": 64}):
        monkeypatch.setattr(stage_ab, "column_plan", lambda *a, **k: dict(column(*a, **k), **bad))
        before = stage_a_apply.launches["focused"]
        with pytest.raises(RuntimeError, match="launch failed"):
            stage_a_apply("focused", u0, v0, kvp, kvpp, Fs, scal, p)
        assert stage_a_apply.launches["focused"] == before
        monkeypatch.undo()
    for bad in ({"grid": (1, 1, 1)}, {"smem": stiffness.SMEM_MAX + 8192}):
        monkeypatch.setattr(stage_ab, "plane_plan", lambda *a, **k: dict(plane(*a, **k), **bad))
        before = stage_b_apply.launches["focused"]
        with pytest.raises(RuntimeError, match="launch failed"):
            stage_b_apply(*args[:6], yA, *args[6:])
        assert stage_b_apply.launches["focused"] == before
        monkeypatch.undo()
    ref = stage_plain(*args)
    got = stage_b_apply(*args[:6], stage_a_apply("focused", u0, v0, kvp, kvpp, Fs, scal, p),
                        *args[6:])
    assert _rel(got, ref) < 1e-5


def test_wrappers_refuse_bad_cuda_input(cuda):
    lat = LatticeStiffness(GRID, 2, (0.1, 0.1, 0.1), torch.float32)
    F = pack_const(lat, 1.0, cuda)
    x = torch.zeros(lat.gdims, device=cuda)
    for bad in (x.transpose(0, 1).contiguous().transpose(0, 1), x.cpu(), x.double()):
        with pytest.raises(ValueError):
            stiffness_apply([bad], [F], 2)
    with pytest.raises(ValueError):
        stiffness_apply([x], [pack_const(lat, 1.0, "cpu")], 2)  # coefficient on the CPU
    for bad in (x.cpu(), x.double()):
        with pytest.raises(ValueError):
            stiffness_axis0_apply([bad], [F], 2)
        with pytest.raises(ValueError):
            stiffness_axes12_apply([x], [F], bad, 2)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_model_on_gpu_matches_cpu(order, cuda):
    """The same fp64 model on the card (K2 per stage) and on the CPU (plain)."""
    rng = np.random.default_rng(order)
    c0, rho0 = rng.uniform(1400, 1600, 96), rng.uniform(900, 1100, 96)
    models = []
    for dev in ("cpu", cuda):
        mesh = create_box((6, 4, 4), (0, 0, 0), (1.0, 0.5, 0.5))
        tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
        models.append(LinearSpectralExplicit(mesh, None, 3, c0, rho0, 0.5e6, 6e4, 1500.0,
                                             order, 1e-8, dtype=torch.float64, device=dev))
    u0, v0 = (rng.standard_normal(models[0].number_of_dofs()) for _ in range(2))
    outs = []
    for m in models:
        assert m.step_kind == "fused"
        m.u_n, m.v_n = state_from_numpy(u0, v0, m.device)
        before = stage_apply.launches["linear"]
        u, v, _ = m.rk(0.0, 5e-8)
        launched = stage_apply.launches["linear"] - before
        outs.append((u.cpu(), v.cpu(), launched, m.energy()))
    assert outs[0][2] == 0 and outs[1][2] == 5 * order
    assert _rel(outs[1][0], outs[0][0]) < 1e-12
    assert _rel(outs[1][1], outs[0][1]) < 1e-12
    assert abs(outs[1][3] - outs[0][3]) < 1e-12 * abs(outs[0][3])


def test_focused_model_on_gpu_matches_cpu(cuda):
    """The fp64 focused model (K2 kind ``focused``, heterogeneous medium, the
    HITU facet layout) on the card and on the CPU, 5 RK4 steps."""
    rng = np.random.default_rng(9)
    c0, rho0 = rng.uniform(1400, 1600, 96), rng.uniform(900, 1100, 96)
    models = []
    for dev in ("cpu", cuda):
        mesh = create_box((6, 4, 4), (0, 0, 0), (1.0, 0.5, 0.5))
        tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12}, default=2)
        models.append(WesterveltSpectralFocused(
            mesh, None, 3, c0, rho0, 4e-3, 3.5, 0.5e6, 6e4, 1500.0, 4, 1e-8,
            aperture_radius=0.2, focal_distance=0.6, center=np.array([0.0, 0.25, 0.25]),
            dtype=torch.float64, device=dev))
    u0, v0 = (rng.standard_normal(models[0].number_of_dofs()) for _ in range(2))
    outs = []
    for m in models:
        assert m.step_kind == "fused"
        m.u_n, m.v_n = state_from_numpy(u0, v0, m.device)
        before = stage_apply.launches["focused"]
        u, v, _ = m.rk(0.0, 5e-8)
        outs.append((u.cpu(), v.cpu(), stage_apply.launches["focused"] - before))
    assert outs[0][2] == 0 and outs[1][2] == 20
    assert _rel(outs[1][0], outs[0][0]) < 1e-12
    assert _rel(outs[1][1], outs[0][1]) < 1e-12


def test_two_kernel_focused_model_on_gpu_matches_cpu(cuda, monkeypatch):
    """``FUS_STAGE_V3=0``: the fp64 focused model through K5a and K5b on the
    card (20 launches of each for 5 RK4 steps, none of K2) equals the CPU
    run; ``FUS_V3=0``: its unfused step through K4a and K4b too."""
    monkeypatch.setenv("FUS_STAGE_V3", "0")
    monkeypatch.setenv("FUS_V3", "0")
    rng = np.random.default_rng(9)
    c0, rho0 = rng.uniform(1400, 1600, 96), rng.uniform(900, 1100, 96)
    models = []
    for dev in ("cpu", cuda):
        mesh = create_box((6, 4, 4), (0, 0, 0), (1.0, 0.5, 0.5))
        tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12}, default=2)
        models.append(WesterveltSpectralFocused(
            mesh, None, 3, c0, rho0, 4e-3, 3.5, 0.5e6, 6e4, 1500.0, 4, 1e-8,
            aperture_radius=0.2, focal_distance=0.6, center=np.array([0.0, 0.25, 0.25]),
            dtype=torch.float64, device=dev))
    u0, v0 = (rng.standard_normal(models[0].number_of_dofs()) for _ in range(2))
    outs = []
    for m in models:
        assert m.step_kind == "fused"
        m.u_n, m.v_n = state_from_numpy(u0, v0, m.device)
        before = (stage_a_apply.launches["focused"], stage_b_apply.launches["focused"],
                  stage_apply.launches["focused"])
        u, v, _ = m.rk(0.0, 5e-8)
        after = (stage_a_apply.launches["focused"], stage_b_apply.launches["focused"],
                 stage_apply.launches["focused"])
        x, y = state_from_numpy(u0, v0, m.device)
        k4 = stiffness_axis0_apply.launches
        uu, _, _ = make_scan_from_step(m.unfused_step())(m.consts, x, y, 0.0, 5e-8, 1e-8)
        outs.append((u.cpu(), v.cpu(), [b - a for a, b in zip(before, after)], uu.cpu(),
                     stiffness_axis0_apply.launches - k4))
    assert outs[0][2] == [0, 0, 0] and outs[1][2] == [20, 20, 0]
    assert outs[0][4] == 0 and outs[1][4] == 20
    assert _rel(outs[1][0], outs[0][0]) < 1e-12
    assert _rel(outs[1][1], outs[0][1]) < 1e-12
    assert _rel(outs[1][3], outs[0][3]) < 1e-12
    assert _rel(outs[1][3], outs[1][0]) < 1e-12


def _wave_args(kind, lat, rng, device, dg0, sep):
    """Random K3 operands of ``kind``: the step state, coefficients, dense
    extras (for ``sep`` the separable (a, P) of inv_m), packed facets and a
    step table at dt = 0.02."""
    args = _stage_args(kind, lat, rng, device, (0, 0, 0), False, dg0)
    _, u0, v0, _, _, _, Fs, dense, facets, _, p, _ = args
    G0, G1, G2 = lat.gdims
    if sep:
        dense = [torch.as_tensor(rng.uniform(0.5, 1.5, shape), dtype=lat.dtype, device=device)
                 for shape in ((G0,), (1, G1, G2))]
    srcs = [list(rng.uniform(-2.0, 2.0, len(KIND_FACET[kind]) - 1)) for _ in range(4)]
    return dict(kind=kind, u0=u0, v0=v0, scal4=step_table(kind, explicit_tables(4), 0.02, srcs),
                Fs=Fs, dense=dense, facets=facets, p=p)


# K3 at p = 4 on the small grids, and on the tile grids (ragged, one cell
# across, unit cells) at p = 1..8
K3_CASES = [(grid, 4) for grid in GRIDS] + [(grid, p) for grid in TILE_GRIDS
                                            for p in range(1, 9)]
RINGS = ["default ring", "smallest ring"]


def _use_ring(ring, monkeypatch):
    """The smallest ring ``wave_plan`` accepts, of one-cell slabs: every
    slot reused as early as the schedule allows, on every lattice of more
    than 3·lag + 1 cells."""
    if ring == "smallest ring":
        monkeypatch.setattr(step_wave, "RING_SPARE", 0)
        monkeypatch.setattr(step_wave, "WAVE_SLAB", 1)


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
@pytest.mark.parametrize("grid,degree", K3_CASES)
def test_k3_matches_plain(grid, degree, kind, dtype, ring, cuda, monkeypatch):
    """K3 (a whole RK4 step in one launch) against ``step_wave_plain``:
    constant and DG-0 coefficients, and inv_m separable for linear and
    lossy; at the default ring and the smallest sound one."""
    _use_ring(ring, monkeypatch)
    h = (0.1, 0.14, 0.07) if grid in GRIDS else (1.0, 1.0, 1.0)
    lat = LatticeStiffness(grid, degree, h, dtype)
    rng = np.random.default_rng(len(kind) + degree)
    forms = [(False, False), (True, False)]
    forms += [(False, True), (True, True)] if kind in ("linear", "lossy") else []
    for dg0, sep in forms:
        args = _wave_args(kind, lat, rng, cuda, dg0, sep)
        before = step_wave_apply.launches[kind]
        got = step_wave_apply(**args)
        assert step_wave_apply.launches[kind] == before + 1
        ref = step_wave_plain(**args)
        step_wave_check()
        for a, b in zip(got, ref):
            assert _rel(a, b) < TOLS[dtype]


def test_k3_result_does_not_depend_on_the_grid(cuda, monkeypatch):
    """The ticket order makes the step independent of how many blocks run
    it: 1 block, a few, as many as are resident (0), and more than there
    are work items give u1, v1 bit for bit, at the smallest sound ring."""
    _use_ring("smallest ring", monkeypatch)
    lat = LatticeStiffness((20, 9, 9), 4, (0.1, 0.14, 0.07), torch.float32)
    args = _wave_args("focused", lat, np.random.default_rng(3), cuda, True, False)
    ref = step_wave_apply(**args, grid=0)
    for grid in (1, 7, 100000):
        got = step_wave_apply(**args, grid=grid)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    step_wave_check()


def test_k3_refused_plan_raises(cuda, monkeypatch):
    """A plan the C entry refuses (a ring below 3·lag + 1 slabs, or a grid
    that leaves nodes without an owner) raises, counts no launch, and
    leaves the next launch right."""
    lat = LatticeStiffness((40, 5, 5), 4, (1.0, 1.0, 1.0), torch.float32)
    args = _wave_args("focused", lat, np.random.default_rng(6), cuda, False, False)
    plan = step_wave.wave_plan
    for bad in ({"ring": 3 * step_wave.WAVE_LAG}, {"grid": (1, 1, 1)}):
        monkeypatch.setattr(step_wave, "wave_plan", lambda *a, **k: dict(plan(*a, **k), **bad))
        before = step_wave_apply.launches["focused"]
        with pytest.raises(RuntimeError, match="launch failed"):
            step_wave_apply(**args)
        assert step_wave_apply.launches["focused"] == before
        monkeypatch.undo()
    got = step_wave_apply(**args)
    step_wave_check()
    assert _rel(got[0], step_wave_plain(**args)[0]) < TOLS[torch.float32]


def test_k3_error_word_raises(cuda):
    """A set error word (what a dependency wait that gave up leaves) stops
    every later launch at once, and the wrapper raises; the word is then
    cleared and the next step is right again."""
    lat = LatticeStiffness(GRID, 4, (0.1, 0.14, 0.07), torch.float32)
    args = _wave_args("linear", lat, np.random.default_rng(4), cuda, False, False)
    step_wave_check()
    step_wave._error_word(cuda).fill_(1)
    step_wave_apply(**args)
    with pytest.raises(RuntimeError, match="dependency wait"):
        step_wave_check()
    got = step_wave_apply(**args)
    step_wave_check()
    assert _rel(got[0], step_wave_plain(**args)[0]) < TOLS[torch.float32]


@pytest.mark.parametrize("name", ["linear", "focused"])
def test_k3_model_matches_k2_model(name, cuda, monkeypatch):
    """``FUS_STEP_WAVE=1``: the fp64 model on the card through K3 (5
    launches for 5 RK4 steps, none of K2; linear in a homogeneous medium
    with inv_m separable) equals the same model through K2."""
    rng = np.random.default_rng(9)
    c0, rho0 = ((1500.0, 1000.0) if name == "linear"
                else (rng.uniform(1400, 1600, 96), rng.uniform(900, 1100, 96)))
    u0, v0 = None, None
    outs = []
    for wave in (False, True):
        monkeypatch.setenv("FUS_STEP_WAVE", "1" if wave else "0")
        mesh = create_box((6, 4, 4), (0, 0, 0), (1.0, 0.5, 0.5))
        if name == "linear":
            tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
            m = LinearSpectralExplicit(mesh, None, 3, c0, rho0, 0.5e6, 6e4, 1500.0, 4, 1e-8,
                                       dtype=torch.float64, device=cuda)
        else:
            tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12}, default=2)
            m = WesterveltSpectralFocused(
                mesh, None, 3, c0, rho0, 4e-3, 3.5, 0.5e6, 6e4, 1500.0, 4, 1e-8,
                aperture_radius=0.2, focal_distance=0.6, center=np.array([0.0, 0.25, 0.25]),
                dtype=torch.float64, device=cuda)
        assert (m.stage_cls is FusedRKStepWave) == wave
        assert ("inv_m__sep0" in m.consts) == (wave and name == "linear")
        if u0 is None:
            u0, v0 = (rng.standard_normal(m.number_of_dofs()) for _ in range(2))
        m.u_n, m.v_n = state_from_numpy(u0, v0, m.device)
        before = step_wave_apply.launches[name], stage_apply.launches[name]
        u, v, _ = m.rk(0.0, 5e-8)
        step_wave_check()
        after = step_wave_apply.launches[name], stage_apply.launches[name]
        outs.append((u, v, (after[0] - before[0], after[1] - before[1])))
    assert outs[0][2] == (0, 20) and outs[1][2] == (5, 0)
    assert _rel(outs[1][0], outs[0][0]) < 1e-12
    assert _rel(outs[1][1], outs[0][1]) < 1e-12


# K2 with its band operand (hybrid lattices): every kind and degree on a
# lattice no tile divides and on a one-cell channel, unit cells, the band
# ending inside the lattice, under the default plan and the main path's tile
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("degree", range(1, 9))
@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("grid", COMPILED_GRIDS)
def test_k2_band_matches_plain(grid, plan, kind, degree, dtype, cuda, monkeypatch):
    _use_plan(plan, monkeypatch)
    grid, compiled = _tile_grid(grid, degree, dtype, "K2+band")
    compiled &= stiffness.compiled_key(degree, dtype, ("K2+band", kind)) is not None
    lat = LatticeStiffness(grid, degree, (1.0, 1.0, 1.0), dtype)
    rng = np.random.default_rng(degree + 3 * len(kind))
    G0, G1, G2 = lat.gdims
    for (present, final), rows in ((STAGES[2], G0 // 2 + 1), (STAGES[6], G0)):
        args = _stage_args(kind, lat, rng, cuda, present, final, False)
        band = torch.as_tensor(rng.standard_normal((rows, G1, G2)), dtype=dtype, device=cuda)
        before = dict(stage_apply.band_launches), dict(stage_apply.launches)
        tiles = dict(stage_apply.tiles)
        got = stage_apply(*args, band=band)
        assert stage_apply.band_launches[kind] == before[0].get(kind, 0) + 1
        assert dict(stage_apply.launches) == before[1]
        took = _took(stage_apply.tiles, tiles)
        assert len(took) == 1 and (not compiled or took[0].endswith("compiled")), took
        ref = stage_plain(*args, band=band)
        for a, b in (zip(got, ref) if final else [(got, ref)]):
            assert _rel(a, b) < TOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", sorted(KIND_FIELDS))
@pytest.mark.parametrize("grid,plan", EQUAL_GRIDS)
def test_k2_zero_band_equals_k2_bit_for_bit(grid, plan, kind, dtype, cuda, monkeypatch):
    """K2's band kernels (the main path's compile-time tile for fp32
    westervelt on (6, 4, 16)) with an all-zero band equal the band-less K2."""
    _use_plan(plan, monkeypatch)
    lat = LatticeStiffness(grid, 4, (1.0, 1.0, 1.0), dtype)
    rng = np.random.default_rng(len(kind))
    G0, G1, G2 = lat.gdims
    for dg0 in (False, True):
        for present, final in (STAGES[2], STAGES[6]):
            args = _stage_args(kind, lat, rng, cuda, present, final, dg0)
            whole = stage_apply(*args)
            for rows in (5, G0):
                zero = stage_apply(*args, band=torch.zeros((rows, G1, G2), dtype=dtype,
                                                           device=cuda))
                for a, b in (zip(zero, whole) if final else [(zero, whole)]):
                    assert torch.equal(a, b)


def test_k2_bad_band_raises(cuda):
    """A band of the wrong shape, dtype or device raises; nothing falls back."""
    lat = LatticeStiffness(GRID, 4, (1.0, 1.0, 1.0), torch.float32)
    args = _stage_args("westervelt", lat, np.random.default_rng(0), cuda, (1, 0, 0), False, False)
    G0, G1, G2 = lat.gdims
    before = dict(stage_apply.band_launches)
    for bad in (torch.zeros((G0 + 1, G1, G2), device=cuda), torch.zeros((0, G1, G2), device=cuda),
                torch.zeros((5, G1, G2 + 1), device=cuda), torch.zeros((5, G1, G2), device=cuda,
                                                                      dtype=torch.float64),
                torch.zeros((5, G1, G2)), torch.zeros((5, G2, G1), device=cuda).transpose(1, 2)):
        with pytest.raises(ValueError):
            stage_apply(*args, band=bad)
    assert dict(stage_apply.band_launches) == before


def test_bowl_model_on_gpu_matches_cpu(cuda):
    """The fp64 Westervelt model on a bowl-fitted (hybrid) lattice on the
    card (K2 + band, K6 in torch) and on the CPU (plain), 5 RK4 steps."""
    from fenicsxfus_tpu_torch import WesterveltSpectralExplicit
    from fenicsxfus_tpu_torch.core.bowl import create_bowl_box

    rng = np.random.default_rng(12)
    models = []
    for dev in ("cpu", cuda):
        mesh, _ = create_bowl_box((8, 7, 7), (0, 0, 0), (1.0, 0.9, 0.9), 0.7, 0.35)
        nc = mesh.num_cells
        c0, rho0 = np.random.default_rng(5).uniform(0.9, 1.1, (2, nc))
        dt = 0.3 * mesh.h_min() / 9  # stable (tests/test_hybrid.py's step)
        models.append(WesterveltSpectralExplicit(mesh, None, 3, c0, rho0, 4e-3, 3.5, 1 / 0.3, 1.0,
                                                 1.0, 4, dt, dtype=torch.float64, device=dev))
    u0, v0 = (0.01 * rng.standard_normal(models[0].number_of_dofs()) for _ in range(2))
    outs = []
    for m in models:
        assert m.step_kind == "fused" and m.ops.hybrid is not None
        m.u_n, m.v_n = state_from_numpy(u0, v0, m.device)
        before = stage_apply.band_launches["westervelt"]
        u, v, _ = m.rk(0.0, 5 * m.dt)
        outs.append((u.cpu(), v.cpu(), stage_apply.band_launches["westervelt"] - before))
    assert outs[0][2] == 0 and outs[1][2] == 20
    assert _rel(outs[1][0], outs[0][0]) < 1e-12
    assert _rel(outs[1][1], outs[0][1]) < 1e-12


# The implicit (SDIRK) models on the card: K1 is the CG matvec in fp64, one
# field (linear) or two (lossy), on a uniform box and on a bowl mesh; the
# same steps through the plain stiffness (``SEMOperators.plain()``) give
# the same CG iteration counts and fields within 1e-10.
@pytest.mark.parametrize("mesh_kind", ["box", "bowl"])
@pytest.mark.parametrize("kind", ["linear", "lossy"])
def test_implicit_model_k1_matches_plain(kind, mesh_kind, cuda):
    from fenicsxfus_tpu_torch import LinearSpectralImplicit, LossySpectralImplicit, create_bowl_box
    from fenicsxfus_tpu_torch.models.common import run_steps

    if mesh_kind == "box":
        mesh = create_box((7, 4, 5), (0, 0, 0), (1.0, 0.6, 0.7))
    else:
        mesh = create_bowl_box((16, 7, 7), (0, 0, 0), (1.0, 0.9, 0.9), 0.9, 0.25,
                               blend=0.08, lateral_hold=0.08)[0]
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    rng = np.random.default_rng(12)
    c0 = rng.uniform(0.9, 1.1, mesh.num_cells)
    args = (3, c0, 1.0) + ((2e-3,) if kind == "lossy" else ()) + (3.0, 1.0, 1.0, 4, 2e-3)
    cls = LossySpectralImplicit if kind == "lossy" else LinearSpectralImplicit
    model = cls(mesh, None, *args, device=cuda)
    u0, v0 = state_from_numpy(1e-3 * rng.standard_normal(model.ops.ndofs),
                              rng.standard_normal(model.ops.ndofs), device=cuda)
    runs = []
    for ops in (None, model.ops.plain()):
        stats = []
        before = stiffness_apply.launches
        u, v, _ = run_steps(model.dirk_step(ops=ops, stats=stats), model.consts, u0, v0, 0.0,
                            [model.dt] * 3)
        runs.append((u, v, [s[0] for s in stats], stiffness_apply.launches - before))
    (uk, vk, ik, nk), (up, vp, ip, npl) = runs
    assert nk > 0 and npl == 0 and ik == ip
    assert _rel(uk, up) < 1e-10 and _rel(vk, vp) < 1e-10


# The general per-cell path (no kernel: gather, per-cell products in torch,
# the deterministic fold) on the card, on the unstructured distorted box of
# tools/unstructured_solve.py.
def _general_ops(dtype, device, nx=5):
    from fenicsxfus_tpu_torch import SEMOperators
    from fenicsxfus_tpu_torch.tools.unstructured_solve import distorted_box

    ops = SEMOperators(distorted_box(nx), 4, dtype=dtype, device=device)
    assert ops.lattice is None and ops.K_ref is None
    return ops


def test_general_scatter_is_deterministic(cuda):
    """The fold gives the same bits twice on the card (no atomics), and
    agrees with the sorted segment sum and with the CPU's fp64 fold."""
    ops = _general_ops(torch.float32, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    yc = torch.randn((ops.num_cells,) + (ops.N,) * 3, generator=gen, device=cuda)
    a, b = ops.scatter(yc), ops.scatter(yc)
    assert torch.equal(a, b)
    assert _rel(ops.scatter_segsum(yc), a) < 1e-5
    cpu = _general_ops(torch.float64, "cpu")
    assert _rel(a.cpu(), cpu.scatter(yc.cpu().double())) < 1e-5


@pytest.mark.parametrize("dense", ["1", "0"])
def test_general_apply_fp32_matches_fp64(dense, cuda, monkeypatch):
    """The general apply in fp32 (the dense tabulation, or with
    ``FUS_DENSE_TAB=0`` the sum-factorised chain) against the oracle
    ``stiffness_apply_generic`` in fp64 on the card, O(1) coefficients on
    O(1) cells (h = 1/5), with TF32 off."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    monkeypatch.setenv("FUS_DENSE_TAB", dense)
    o32, o64 = _general_ops(torch.float32, cuda), _general_ops(torch.float64, cuda)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, o64.ndofs))
    c = [rng.uniform(0.5, 2.0, o64.num_cells), 0.7]
    ref = o64.stiffness_apply_generic([torch.as_tensor(v, device=cuda) for v in x], c)
    y = o32.stiffness_apply([torch.as_tensor(v, dtype=torch.float32, device=cuda) for v in x],
                            [o32.stiff_coeff(v) for v in c])
    assert _rel(y, ref) < 1e-5
    y64 = o64.stiffness_apply([torch.as_tensor(v, device=cuda) for v in x], c)
    assert _rel(y64, ref) < 1e-12


def test_general_model_on_gpu_matches_cpu(cuda):
    """The fp64 Westervelt model of tools/unstructured_solve.py on the
    distorted box, on the card and on the CPU, 5 RK4 steps."""
    from fenicsxfus_tpu_torch.tools.unstructured_solve import build_model, distorted_box

    rng = np.random.default_rng(8)
    outs = []
    for dev in ("cpu", cuda):
        m = build_model(distorted_box(4), 3, torch.float64, dev)
        if not outs:
            u0, v0 = (0.01 * rng.standard_normal(m.number_of_dofs()) for _ in range(2))
        m.u_n, m.v_n = state_from_numpy(u0, v0, m.device)
        u, v, _ = m.rk(0.0, 5 * m.dt)
        assert m.step_kind == "unfused"
        outs.append((u.cpu(), v.cpu()))
    assert _rel(outs[1][0], outs[0][0]) < 1e-12 and _rel(outs[1][1], outs[0][1]) < 1e-12
