"""The launch plans of the split kernels, checked on the CPU: the column
march of K4a and K5a (``ops/stiffness.py::column_plan``,
``csrc/column.cuh``) and the plane tile of K4b and K5b (``plane_plan``,
``csrc/plane.cuh``), at K5b's operands and at K4b's.

For p = 1..8 at the HITU lattice, the headline, a ragged lattice and the two
channels one cell across: every node has exactly one owner, every node a
block reads lies inside the lattice (and, for the plane tile, inside the
block's shared plane), the shared memory fits a block, and the grid reaches
the card's SM count wherever the lattice has that many blocks to give.
``_column_walk`` and ``_plane_ranges`` restate the kernels' ownership and
read arithmetic from the plan.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from fenicsxfus_tpu_torch.ops import stage_ab, stiffness
from fenicsxfus_tpu_torch.ops.stiffness import (
    ITEMSIZE,
    SMEM_MAX,
    column_plan,
    column_plan_ints,
    plane_plan,
    plane_plan_ints,
    plane_smem_bytes,
)

CELLS = {
    "HITU": (80, 47, 47),
    "headline": (104, 104, 104),
    "ragged": (13, 11, 17),
    "channel 41": (41, 1, 1),
    "channel 5": (5, 1, 1),
}
SMS = 132  # streaming multiprocessors of an H100


def _stencil_span(g, n, p):
    """Lowest and highest node the stencil of axis node(s) ``g`` reads along
    that axis (lattice.cuh: cell_sum of the node's cell, and at an interface
    of the cell below)."""
    c = np.minimum(g // p, n - 1)
    k = g - c * p
    low = np.where((k == 0) & (c > 0), (c - 1) * p, c * p)
    return low, c * p + p


def _column_walk(c_begin, c_end, n0, p):
    """The planes one block of column.cuh::column_march computes (k = 0..p-1
    of each owned cell, and k = p on the lattice's last cell) and the planes
    it loads, in order: the N planes of the first cell it reads (the one
    before the slab, after the first slab), then planes 1..p of each next
    cell."""
    c_first = c_begin - 1 if c_begin > 0 else 0
    computed = []
    for c in range(c_begin, c_end):
        kmax = p if c == n0 - 1 else p - 1
        computed += [c * p + k for k in range(kmax + 1)]
    loaded = [c_first * p + j for j in range(p + 1)]
    for c in range(c_first + 1, c_end):
        loaded += [c * p + j for j in range(1, p + 1)]
    return computed, loaded


def _plane_ranges(plan, gdims, p):
    """Per in-plane axis, each tile's (owned begin, owned end, origin) and
    (loaded begin, loaded end), as plane.cuh::plane_stencil derives them
    (the origin A - p is the lattice coordinate of a shared plane's first
    entry); along g0, each run's owned planes."""
    G0, G1, G2 = gdims
    (t1, t2), R = plan["tile"], plan["planes"]
    gx, gy, gz = plan["grid"]
    out = {}
    for name, t, nb, G in (("g2", t2, gx, G2), ("g1", t1, gy, G1)):
        A = np.arange(nb) * t
        E = np.minimum(A + t, G)
        O = A - p
        out[name] = np.stack([A, E, O], 1)
        out[name + " loaded"] = np.stack([np.maximum(O, 0), np.minimum(E + 1, G)], 1)
    begin = np.arange(gz) * R
    out["g0"] = np.stack([begin, np.minimum(begin + R, G0)], 1)
    return out


@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("name", list(CELLS))
def test_column_plan_owns_every_node_once_and_reads_inside(name, p):
    cells = CELLS[name]
    gdims = tuple(n * p + 1 for n in cells)
    G0, cols, n0 = gdims[0], gdims[1] * gdims[2], cells[0]
    plan = column_plan(gdims, p)
    C, S, (gx, gy) = plan["columns"], plan["slab"], plan["grid"]
    assert C % 32 == 0 and 32 <= C <= stiffness.COLUMN_MAX_THREADS and S >= 1
    # the grid csrc/column.cuh::read_column_plan accepts
    assert (gx, gy) == (-(-cols // C), -(-n0 // S))
    assert list(column_plan_ints(plan)) == [C, S, gx, gy]
    # columns: the blocks' runs partition the plane, a thread each
    owners = np.zeros(cols, int)
    for bx in range(gx):
        A, E = bx * C, min(bx * C + C, cols)
        assert 0 < E - A <= C
        owners[A:E] += 1
    assert (owners == 1).all()
    # planes: the slabs' marches compute every plane once, and load each
    # plane they read once, inside the lattice
    owners = np.zeros(G0, int)
    for by in range(gy):
        c_begin, c_end = by * S, min(by * S + S, n0)
        computed, loaded = _column_walk(c_begin, c_end, n0, p)
        owners[computed] += 1
        assert len(set(loaded)) == len(loaded) and loaded == sorted(loaded)
        assert 0 <= loaded[0] and loaded[-1] < G0
        low, high = _stencil_span(np.array(computed), n0, p)
        assert loaded[0] <= low.min() and high.max() <= loaded[-1]
        # the registers hold one cell: each computed plane's cell is whole
        # among the planes loaded up to it
        for g in computed:
            c = min(g // p, n0 - 1)
            assert all(c * p + j in loaded for j in range(p + 1))
    assert (owners == 1).all()
    # one block per SM at least, where the lattice has that many to give
    assert gx * gy >= min(SMS, -(-cols // 32) * n0)


def _check_plane_plan(name, p, dtype, operands):
    """Replay the plane plan of each (nf, nr) of ``operands`` on lattice
    ``name`` at degree p."""
    cells = CELLS[name]
    gdims = tuple(n * p + 1 for n in cells)
    for nf, nr in operands:
        plan = plane_plan(gdims, p, nf, dtype, nr=nr)
        (t1, t2), R = plan["tile"], plan["planes"]
        gx, gy, gz = plan["grid"]
        assert t1 % p == 0 and t2 % p == 0 and R >= 1 and plan["halo"] == (p, 1)
        assert plan["smem"] == plane_smem_bytes(t1, t2, p, nf, nr, ITEMSIZE[dtype]) <= SMEM_MAX
        # a thread per column, and enough threads to load a plane two nodes each
        threads = plan["threads"]
        assert threads % 32 == 0 and t1 * t2 <= threads <= stiffness.PLANE_MAX_THREADS
        assert 2 * threads >= (t1 + p + 1) * (t2 + p + 1)
        # the grid csrc/plane.cuh::read_plane_plan accepts
        assert (gx, gy, gz) == (-(-gdims[2] // t2), -(-gdims[1] // t1), -(-gdims[0] // R))
        assert list(plane_plan_ints(plan)) == [t1, t2, R, threads, plan["smem"], gx, gy, gz]
        r = _plane_ranges(plan, gdims, p)
        # axes 1 and 2: the tiles' owned ranges partition the axis, and each
        # tile's stencil reads stay in its loaded range and its shared plane
        for axis, G, t, nb, n in (("g1", gdims[1], t1, gy, cells[1]),
                                  ("g2", gdims[2], t2, gx, cells[2])):
            owners = np.zeros(G, int)
            assert r[axis].shape == (nb, 3)
            for (A, E, O), (lo, hi) in zip(r[axis], r[axis + " loaded"]):
                assert 0 < E - A <= t  # a thread for every column
                owners[A:E] += 1
                low, high = _stencil_span(np.arange(A, E), n, p)
                assert 0 <= lo <= low.min() and high.max() < hi <= G
                assert lo - O >= 0 and hi - O <= t + p + 1  # inside the shared plane
            assert (owners == 1).all(), f"{axis}: nodes owned {np.unique(owners)} times"
        # axis 0: the runs partition the planes; a run reads only its own
        owners = np.zeros(gdims[0], int)
        for A, E in r["g0"]:
            assert 0 < E - A <= R
            owners[A:E] += 1
        assert (owners == 1).all()
        # one block per SM at least, where the lattice has that many to give
        most = -(-gdims[2] // p) * -(-gdims[1] // p) * gdims[0]
        assert gx * gy * gz >= min(SMS, most)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("name", list(CELLS))
def test_plane_plan_owns_every_node_once_and_reads_inside(name, p, dtype):
    # K5b: one field from 3 raw operands (linear) or two from 4 (the others)
    _check_plane_plan(name, p, dtype, ((1, 3), (2, 4)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("name", list(CELLS))
def test_k4b_plane_plan_owns_every_node_once_and_reads_inside(name, p, dtype):
    # K4b: one or two fields, their own raw operands (nr = nf), and K4b's
    # launch, which copies them straight into the field planes (nr = 0)
    _check_plane_plan(name, p, dtype, ((1, 1), (2, 2), (1, 0), (2, 0)))


def test_main_path_plans_keep_the_starting_sizes():
    """The fp32 p = 4 plans at the HITU lattice and the headline keep the
    starting sizes, so K4a/K5a and K4b/K5b take their compile-time main-path
    kernels (csrc/column.cuh with_column_shape, csrc/plane.cuh
    with_plane_shape: the kPlaneMainT1 x kPlaneMainT2 tile, one thread per
    column), at K5b's operands and at K4b's."""
    for gdims in ((321, 189, 189), (417, 417, 417)):
        col = column_plan(gdims, 4)
        assert (col["columns"], col["slab"]) == (stiffness.COLUMN_THREADS,
                                                 stiffness.COLUMN_SLAB)
        for nf, nr in ((1, 3), (2, 4), (1, 0), (2, 0)):
            plan = plane_plan(gdims, 4, nf, torch.float32, nr=nr)
            assert plan["tile"] == stiffness.PLANE_TILE == (8, 32)
            assert plan["planes"] == stiffness.PLANE_RUN and plan["threads"] == 8 * 32


def test_plans_are_cut_to_the_lattice_in_order():
    """Below the card's SM count the column plan halves the slab first, then
    the columns; the plane plan halves the run first, then the tile along
    g1, then along g2."""
    gdims = (37, 21, 29)  # (9, 5, 7) cells at p = 4: 609 columns
    # 256 columns, slab 8 -> 3 x 2 blocks; slab 1 -> 27, then 128, 64, 32
    # columns -> 45, 90, 180 >= 132
    assert column_plan(gdims, 4) == {"columns": 32, "slab": 1, "grid": (20, 9)}
    # an 8 x 28 tile (2 x 8 cells cut to the lattice's 7 along g2), run 16
    # -> 2 x 3 x 3 blocks; run 1 -> 222 >= 132
    plan = plane_plan(gdims, 4, 2, torch.float32, nr=4)
    assert plan["tile"] == (8, 28) and plan["planes"] == 1 and plan["grid"] == (2, 3, 37)
    # a lattice of 13 planes: the run reaches 1 (2 x 3 x 13 = 78), then the
    # tile halves along g1 (1 cell: 2 x 6 x 13 = 156)
    plan = plane_plan((13, 21, 29), 4, 2, torch.float32, nr=4)
    assert plan["tile"] == (4, 28) and plan["planes"] == 1 and plan["grid"] == (2, 6, 13)


def test_unsound_plans_raise(monkeypatch):
    gdims = (417, 417, 417)
    with monkeypatch.context() as m:
        m.setattr(stiffness, "COLUMN_THREADS", 1024)
        with pytest.raises(ValueError, match="columns a block"):
            column_plan(gdims, 4)
        m.setattr(stiffness, "COLUMN_THREADS", 48)
        with pytest.raises(ValueError, match="multiple of 32"):
            column_plan(gdims, 4)
    with monkeypatch.context() as m:
        m.setattr(stiffness, "PLANE_MAX_THREADS", 4096)
        m.setattr(stiffness, "SMEM_TARGET", 10**9)
        m.setattr(stiffness, "PLANE_TILE", (64, 64))
        with pytest.raises(ValueError, match="shared memory"):
            plane_plan(gdims, 4, 2, torch.float64, nr=4)
    with monkeypatch.context() as m:
        m.setattr(stiffness, "PLANE_MAX_THREADS", 32)
        with pytest.raises(ValueError, match="threads"):
            plane_plan(gdims, 4, 2, torch.float32, nr=4)
    # the sizes come back with the module's values
    assert column_plan(gdims, 4)["columns"] == 256
    assert plane_plan(gdims, 4, 2, torch.float32, nr=4)["tile"] == (8, 32)


def test_plans_have_one_home_and_no_import_cycle():
    """The plans live in ops/stiffness.py, which K4 runs and which imports
    nothing of the stage modules; ops/stage_ab.py takes them from there."""
    src = Path(stiffness.__file__).read_text()
    imported = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
        elif isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
    assert not {m for m in imported if "stage" in m or "step_wave" in m}, imported
    for name in ("column_plan", "column_plan_ints", "plane_plan", "plane_plan_ints"):
        assert getattr(stage_ab, name) is getattr(stiffness, name)
    for name in ("COLUMN_THREADS", "COLUMN_SLAB", "PLANE_TILE", "PLANE_RUN"):
        assert not hasattr(stage_ab, name)
    # K4b's plan: the fields copied straight into the field planes, no raw ones
    for nf in (1, 2):
        assert stiffness.axes12_plan((37, 21, 29), 4, nf, torch.float32) == plane_plan(
            (37, 21, 29), 4, nf, torch.float32, nr=0)
