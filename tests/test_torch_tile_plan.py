"""The launch plan of the tiled K1/K2 kernels (``ops/stiffness.py::tile_plan``,
``csrc/tile.cuh``), checked on the CPU.

For p = 1..8, fp32 and fp64, 1 and 2 stencil fields, at the small test
lattice, the one-cell-across channels, the HITU lattice and the headline:
every node has exactly one owner, every node a block reads lies inside the
lattice and inside the block's shared plane, the shared memory fits a block,
and the two large lattices give the card at least one block per SM. The walk
of ``tile_stencil`` (cells along g0, columns of the tile) is replayed here
from the plan, and ``_ranges`` restates the kernel's ownership and halo
arithmetic.
"""

import numpy as np
import pytest
import torch

from fenicsxfus_tpu_torch.ops.stiffness import (
    ITEMSIZE,
    SMEM_MAX,
    plan_ints,
    tile_plan,
    tile_smem_bytes,
)
from fenicsxfus_tpu_torch.ops import stiffness

CELLS = {
    "small": (9, 5, 7),
    "channel 41": (41, 1, 1),
    "channel 81": (81, 1, 1),
    "HITU": (80, 47, 47),
    "headline": (104, 104, 104),
}
SMS = 132  # streaming multiprocessors of an H100


def _stencil_span(g, n, p):
    """Lowest and highest node the stencil of axis node(s) ``g`` reads along
    that axis (lattice.cuh::axis_term): the node's cell, and at an interface
    the cell below."""
    c = np.minimum(g // p, n - 1)
    k = g - c * p
    low = np.where((k == 0) & (c > 0), (c - 1) * p, c * p)
    return low, c * p + p


def _ranges(plan, gdims, p):
    """Per axis, the ranges of each block index as csrc/tile.cuh's
    ``tile_stencil`` derives them from the plan: [n, 3] int arrays of (owned
    begin, owned end, origin) and [n, 2] arrays of loaded (begin, end);
    ``"g2"``/``"g1"`` per tile, the origin being the lattice coordinate of a
    shared plane's first entry (A - p); ``"g0"`` per slab, planes, the origin
    unused (0)."""
    G0, G1, G2 = gdims
    n0 = (G0 - 1) // p
    (t1, t2), S = plan["tile"], plan["slab"]
    gx, gy, gz = plan["grid"]
    out = {}
    for name, t, nb, G in (("g2", t2, gx, G2), ("g1", t1, gy, G1)):
        A = np.arange(nb) * t
        E = np.minimum(A + t, G)
        O = A - p
        out[name] = np.stack([A, E, O], 1)
        out[name + " loaded"] = np.stack([np.maximum(O, 0), np.minimum(E + 1, G)], 1)
    c_begin = np.arange(gz) * S
    c_end = np.minimum(c_begin + S, n0)
    owned_end = np.where(c_end == n0, G0, c_end * p)
    out["g0"] = np.stack([c_begin * p, owned_end, np.zeros_like(c_begin)], 1)
    out["g0 loaded"] = np.stack([np.maximum(c_begin - 1, 0) * p, c_end * p + 1], 1)
    return out


def _walk_planes(begin_cell, end_cell, n0, p):
    """The planes the walk of one slab computes: k = 0..p-1 of each owned
    cell, and k = p on the lattice's last cell (tile.cuh::tile_stencil)."""
    planes = []
    for c in range(begin_cell, end_cell):
        kmax = p if c == n0 - 1 else p - 1
        planes += [c * p + k for k in range(kmax + 1)]
    return planes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("name", list(CELLS))
def test_plan_owns_every_node_once_and_reads_inside(name, p, dtype):
    cells = CELLS[name]
    gdims = tuple(n * p + 1 for n in cells)
    # K1 with 1 or 2 fields, K2 with 1 or 2 fields from 3 or 4 raw operands
    for nf, nr in ((1, 1), (2, 2), (1, 3), (2, 4)):
        plan = tile_plan(gdims, p, nf, dtype, nr=nr)
        (t1, t2), S = plan["tile"], plan["slab"]
        gx, gy, gz = plan["grid"]
        assert t1 % p == 0 and t2 % p == 0 and S >= 1
        assert plan["halo"] == (p, 1)
        assert plan["smem"] == tile_smem_bytes(t1, t2, p, nf, nr, ITEMSIZE[dtype]) <= SMEM_MAX
        # a thread per column, and enough threads to load a plane two nodes each
        threads = plan["threads"]
        assert threads % 32 == 0 and t1 * t2 <= threads <= 512
        assert 2 * threads >= (t1 + p + 1) * (t2 + p + 1)
        # the grid csrc/tile.cuh::read_plan accepts
        assert (gx, gy, gz) == (-(-gdims[2] // t2), -(-gdims[1] // t1), -(-cells[0] // S))
        assert list(plan_ints(plan)) == [t1, t2, S, plan["threads"], plan["smem"], gx, gy, gz]
        r = _ranges(plan, gdims, p)

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

        # axis 0: the slabs' walks compute every plane once, and read only
        # the planes they load
        owners = np.zeros(gdims[0], int)
        for b in range(gz):
            c_begin, c_end = b * S, min(b * S + S, cells[0])
            planes = _walk_planes(c_begin, c_end, cells[0], p)
            owners[planes] += 1
            A, E, _ = r["g0"][b]
            assert planes == list(range(A, E))
            lo, hi = r["g0 loaded"][b]
            low, high = _stencil_span(np.array(planes), cells[0], p)
            assert 0 <= lo <= low.min() and high.max() < hi <= gdims[0]
            # the ring holds N planes: the walk loads each once, from the
            # cell before the slab (its interface partial) to the last cell
            assert hi - lo == (c_end - max(c_begin - 1, 0)) * p + 1
        assert (owners == 1).all(), f"g0: planes computed {np.unique(owners)} times"
        # ownership is the product of the three axes' ranges, so every node
        # of the lattice has exactly one (block, column, plane)
        if name in ("HITU", "headline"):
            assert gx * gy * gz >= SMS


def _sizes(monkeypatch, nodes, slab=8, target=10**9, min_blocks=1):
    """Start the plan at other module sizes (no halving for shared memory or
    block count unless ``target``/``min_blocks`` ask for it)."""
    monkeypatch.setattr(stiffness, "TILE_NODES", nodes)
    monkeypatch.setattr(stiffness, "SLAB_CELLS", slab)
    monkeypatch.setattr(stiffness, "SMEM_TARGET", target)
    monkeypatch.setattr(stiffness, "MIN_BLOCKS", min_blocks)


def test_plan_too_large_for_shared_memory_raises(monkeypatch):
    gdims = (417, 417, 417)
    _sizes(monkeypatch, (416, 64))
    with pytest.raises(ValueError, match="shared memory"):
        tile_plan(gdims, 4, 2, torch.float32)
    _sizes(monkeypatch, (4, 160))
    with pytest.raises(ValueError, match="threads"):
        tile_plan(gdims, 4, 2, torch.float32)
    # a tile of one cell fits
    _sizes(monkeypatch, (4, 4))
    assert tile_plan(gdims, 4, 2, torch.float32)["smem"] <= SMEM_MAX


def test_plan_sizes_per_type_and_main_path_shapes():
    """The main paths' fp32 plans (K2 at HITU with two fields, K2 and K1 at
    the headline with one) keep the starting tile and slab; fp64 halves the
    tile where fp32's fits; every plan leaves room for three blocks per SM."""
    hitu, head = (321, 189, 189), (417, 417, 417)
    for gd, nf, nr in ((hitu, 2, 4), (head, 1, 3), (head, 1, 1)):
        plan = tile_plan(gd, 4, nf, torch.float32, nr=nr)
        assert plan["tile"] == (8, 32) and plan["slab"] == 8 and plan["threads"] == 256
        assert 3 * plan["smem"] <= SMEM_MAX
        plan64 = tile_plan(gd, 4, nf, torch.float64, nr=nr)
        assert plan64["tile"][0] * plan64["tile"][1] <= 8 * 32
        assert 3 * plan64["smem"] <= SMEM_MAX


def test_plan_overrides_are_cut_to_the_lattice(monkeypatch):
    """Module sizes larger than the lattice are cut to it; below the card's
    SM count the plan halves the slab first, then the tile along g1, then
    along g2."""
    gdims = (37, 21, 29)  # (9, 5, 7) cells at p = 4
    with monkeypatch.context() as m:
        _sizes(m, (200, 8), slab=50)
        plan = tile_plan(gdims, 4, 1, torch.float64)
        assert plan["tile"] == (20, 8) and plan["slab"] == 9 and plan["grid"] == (4, 2, 1)
    # default sizes: 2 x 7 cells and a slab of 8 give 12 blocks; slab 8 -> 1
    # (54 blocks), g1 2 -> 1 cell (108), g2 7 -> 3 cells (162 >= 132)
    plan = tile_plan(gdims, 4, 1, torch.float64)
    assert plan["tile"] == (4, 12) and plan["slab"] == 1 and plan["grid"] == (3, 6, 9)
