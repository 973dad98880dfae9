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

import re
from pathlib import Path

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
# (fields, raw operands): K1 with 1 or 2 fields, K2 with 1 or 2 fields formed
# from 3 or 4 raw operands
RAW = ((1, 1), (2, 2), (1, 3), (2, 4))


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
    for nf, nr in RAW:
        _check_plan(tile_plan(gdims, p, nf, dtype, nr=nr), gdims, cells, p, nf, nr, dtype)
        if name in ("HITU", "headline"):
            assert np.prod(tile_plan(gdims, p, nf, dtype, nr=nr)["grid"]) >= SMS


def _check_plan(plan, gdims, cells, p, nf, nr, dtype):
    """Replay ``plan``'s walk on the lattice of ``cells`` at degree p:
    ownership, halo reads, shared memory, threads, the C entry's checks."""
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


# ------------------------------------------------ the compiled tiles (tiles.cuh)

TILES_CUH = Path(stiffness.__file__).resolve().parents[1] / "csrc" / "tiles.cuh"
KIND_CODES = {"kLinear": "linear", "kLossy": "lossy", "kWestervelt": "westervelt",
              "kFocused": "focused"}
REGISTERS_SM = 65_536


def _tiles_cuh():
    """The entries of csrc/tiles.cuh's lists: {compiled key: (t1, t2)}."""
    out = {}
    for m in re.finditer(r"^\s*X\((float|double), (\d), (\w+), (\d+), (\d+)(?:, (\d+))?\)",
                         TILES_CUH.read_text(), re.M):
        ty, p, what, a, b, c = m.groups()
        dt = {"float": "float32", "double": "float64"}[ty]
        if c is None:  # K1: fields, t1, t2
            key, tile = ("K1", dt, int(p), int(what)), (int(a), int(b))
        else:  # K2: kind, band, t1, t2
            key = ("K2+band" if a == "1" else "K2", dt, int(p), KIND_CODES[what])
            tile = (int(b), int(c))
        assert key not in out, f"{key} listed twice"
        out[key] = tile
    return out


def _raw(key):
    fam, _, _, what = key
    nf = what if fam == "K1" else stiffness.KIND_FIELDS[what]
    return nf, nf if fam == "K1" else stiffness.KIND_RAW[nf]


def test_tiles_cuh_is_the_plans_table():
    """The C table (csrc/tiles.cuh) lists exactly COMPILED_TILES, each at
    degree_tile's tile: the Python plan and the C dispatch agree."""
    table = _tiles_cuh()
    assert set(table) == set(stiffness.COMPILED_TILES)
    for key, tile in table.items():
        nf, nr = _raw(key)
        assert tile == stiffness.degree_tile(key[2], nf, nr, ITEMSIZE[getattr(torch, key[1])])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", range(1, 9))
def test_degree_tile_rule(p, dtype):
    """degree_tile against the rule restated by brute force: whole cells,
    at most 512 threads, two blocks an SM in shared memory (228 KB less 1 KB
    a block) and in registers (TILE_REGISTERS a thread), the halo factor
    closest to the 8 x 32 p = 4 tile's, ties to the longer g2 then g1 rows."""
    isz = ITEMSIZE[dtype]
    for nf, nr in RAW:
        regs = stiffness.TILE_REGISTERS[isz, nf, nr]
        tile = stiffness.degree_tile(p, nf, nr, isz)
        target = 13 * 37 / 256
        fits = []
        for c1 in range(1, 513):
            for c2 in range(1, 513 // c1 + 1):
                t1, t2 = c1 * p, c2 * p
                th = stiffness.tile_threads(t1, t2, p)
                if th > 512 or 2 * th * regs > REGISTERS_SM:
                    continue
                if 2 * (tile_smem_bytes(t1, t2, p, nf, nr, isz) + 1024) > 233_472:
                    continue
                h = (t1 + p + 1) * (t2 + p + 1) / (t1 * t2)
                fits.append((abs(h - target), -t2, -t1, (t1, t2)))
        assert tile == (min(fits)[3] if fits else None)
        if tile is not None:
            t1, t2 = tile
            assert 2 * stiffness.tile_threads(t1, t2, p) * regs <= REGISTERS_SM
    # fp64 p = 8 with two fields from four raw operands has no tile for two
    # blocks an SM
    assert stiffness.degree_tile(8, 2, 4, 8) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", range(1, 9))
def test_degree_plan_owns_every_node_once_and_reads_inside(p, dtype, monkeypatch):
    """The per-degree tiles' plans, replayed as the general plan's: on a
    lattice of two whole tiles and a cut one along g1 and g2 (any block
    count) and at the HITU lattice and the headline (at least one block an
    SM), every node has one owner and every read lies inside."""
    for nf, nr in RAW:
        tile = stiffness.degree_tile(p, nf, nr, ITEMSIZE[dtype])
        if tile is None:
            assert stiffness.degree_plan((9 * p + 1,) * 3, p, nf, dtype, nr) is None
            continue
        c1, c2 = tile[0] // p, tile[1] // p
        with monkeypatch.context() as m:
            m.setattr(stiffness, "MIN_BLOCKS", 1)
            for cells in ((9, 2 * c1 + 1, 2 * c2 + 1), (5, c1, c2)):
                gdims = tuple(n * p + 1 for n in cells)
                plan = stiffness.degree_plan(gdims, p, nf, dtype, nr)
                assert plan["tile"] == tile and plan["threads"] <= 512
                _check_plan(plan, gdims, cells, p, nf, nr, dtype)
            # narrower than the tile: no compiled plan
            gdims = tuple(n * p + 1 for n in (5, c1, c2 - 1) if n > 0)
            if len(gdims) == 3:
                assert stiffness.degree_plan(gdims, p, nf, dtype, nr) is None
        for name in ("HITU", "headline"):
            cells = CELLS[name]
            gdims = tuple(n * p + 1 for n in cells)
            plan = stiffness.degree_plan(gdims, p, nf, dtype, nr)
            _check_plan(plan, gdims, cells, p, nf, nr, dtype)
            assert np.prod(plan["grid"]) >= SMS
            assert 2 * (plan["smem"] + 1024) <= 233_472


def _kernel_of(gdims, p, dtype, kernel):
    fam, what = kernel
    nf = what if fam == "K1" else stiffness.KIND_FIELDS[what]
    nr = nf if fam == "K1" else stiffness.KIND_RAW[nf]
    plan = tile_plan(gdims, p, nf, dtype, nr=nr, kernel=kernel)
    return plan, stiffness.tile_kernel(plan, p, dtype, kernel)


def test_dispatch_mirror():
    """tile_kernel (the Python mirror of the C dispatch) names the compiled
    tile where the plan is its tile, the main tile for fp32 p = 4 at 8 x 32
    (K2 with a band only for westervelt), else the general kernel: for p = 1,
    7, 8, a type or kind without an entry, a lattice narrower than the tile,
    a grid below MIN_BLOCKS, and any other plan."""
    f32, f64 = torch.float32, torch.float64
    big = lambda p: (48 * p + 1,) * 3  # noqa: E731
    for key in stiffness.COMPILED_TILES:
        fam, dt, p, what = key
        plan, name = _kernel_of(big(p), p, getattr(torch, dt), (fam, what))
        assert name.endswith("compiled") and f"p={p}" in name, name
        assert plan["tile"] == _tiles_cuh()[key]
        # the same kernel on the general plan takes the general kernel
        nf, nr = _raw(key)
        general = tile_plan(big(p), p, nf, getattr(torch, dt), nr=nr)
        if general["tile"] != plan["tile"]:
            assert stiffness.tile_kernel(general, p, getattr(torch, dt), (fam, what)).endswith(
                "general")
    for p in (1, 7, 8):
        for dt in (f32, f64):
            for kernel in (("K1", 1), ("K1", 2), ("K2", "focused"), ("K2+band", "westervelt")):
                assert _kernel_of(big(p), p, dt, kernel)[1].endswith("general")
    assert _kernel_of(big(4), 4, f32, ("K1", 1))[1] == "K1 float32 p=4 1f 8x32 main"
    assert _kernel_of(big(4), 4, f32, ("K2", "focused"))[1].endswith("8x32 main")
    assert _kernel_of(big(4), 4, f32, ("K2+band", "westervelt"))[1].endswith("8x32 main")
    assert _kernel_of(big(4), 4, f32, ("K2+band", "focused"))[1].endswith("general")
    assert _kernel_of(big(5), 5, f32, ("K2+band", "focused"))[1].endswith("general")
    assert _kernel_of(big(3), 3, f32, ("K2", "linear"))[1].endswith("general")
    # narrower than the p = 5 fp32 tile (2 x 6 cells) along g2; a grid below
    # MIN_BLOCKS even at a slab of one cell
    assert _kernel_of((21, 51, 26), 5, f32, ("K2", "focused"))[1].endswith("general")
    assert _kernel_of((11, 11, 31), 5, f32, ("K2", "focused"))[1].endswith("general")


# (degree, dtype, kernel, lattice) of each 3D launch of the port's drivers,
# tools and examples at their defaults (and PH1's documented --dtype float64
# and --bowl runs), at its lattice
RUNS = [
    # drivers/ph1.py SC2-BM7 and SC1-BM7 (p = 5, nx = 80): K2, and K1 in
    # the unfused step that chip_smoke.py holds the fused one to
    (5, torch.float32, ("K2", "focused"), (401, 236, 236)),
    (5, torch.float32, ("K2", "lossy"), (401, 236, 236)),
    (5, torch.float32, ("K1", 2), (401, 236, 236)),
    (5, torch.float64, ("K2", "focused"), (401, 236, 236)),
    (5, torch.float64, ("K2", "lossy"), (401, 236, 236)),
    # SC2-BM7 --bowl: westervelt with the band, K1 in estimate_stable_dt
    (5, torch.float32, ("K2+band", "westervelt"), (401, 236, 236)),
    (5, torch.float32, ("K1", 1), (401, 236, 236)),
    (5, torch.float64, ("K2+band", "westervelt"), (401, 236, 236)),
    # the implicit headline's CG (417³) and the lossy implicit model's at
    # the HITU lattice; Newmark; the adaptive models' slopes
    (4, torch.float64, ("K1", 1), (417, 417, 417)),
    (4, torch.float64, ("K1", 2), (321, 189, 189)),
    (4, torch.float64, ("K1", 1), (321, 189, 189)),
    # tools/operator_speed.py at p = 2, 3, 5, 6 (38.3M DOF), const and DG-0
    (2, torch.float32, ("K1", 1), (339, 339, 339)),
    (3, torch.float32, ("K1", 1), (337, 337, 337)),
    (5, torch.float32, ("K1", 1), (336, 336, 336)),
    (6, torch.float32, ("K1", 1), (337, 337, 337)),
    # drivers/bowl_convergence.py (fp64, nx = 20, 28, 36): K2 + band
    # westervelt, K1 in estimate_stable_dt
    (4, torch.float64, ("K2+band", "westervelt"), (81, 49, 49)),
    (4, torch.float64, ("K2+band", "westervelt"), (113, 65, 65)),
    (4, torch.float64, ("K2+band", "westervelt"), (145, 85, 85)),
    (4, torch.float64, ("K1", 1), (145, 85, 85)),
    # the fp64 models on the card (chip_smoke.py [18a] and the experiments'
    # 3D runs): every kind's K2 at p = 4
    (4, torch.float64, ("K2", "linear"), (129, 129, 129)),
    (4, torch.float64, ("K2", "lossy"), (321, 189, 189)),
    (4, torch.float64, ("K2", "westervelt"), (321, 189, 189)),
    (4, torch.float64, ("K2", "focused"), (321, 189, 189)),
    # drivers/hitu.py W-H101-WATER at its published p = 6 (nx = 80, 0.5 MHz):
    # the flat aperture's focused K2 and the bowl-fitted mesh's K2 + band
    (6, torch.float32, ("K2", "focused"), (481, 283, 283)),
    (6, torch.float32, ("K2+band", "westervelt"), (481, 283, 283)),
    # examples/sharded_planewave3d.py (nx = 16, p = 3): K1 in its unfused step
    (3, torch.float32, ("K1", 1), (49, 49, 49)),
    (3, torch.float64, ("K1", 1), (49, 49, 49)),
]


@pytest.mark.parametrize("p,dtype,kernel,gdims", RUNS)
def test_every_3d_run_gets_a_compiled_tile(p, dtype, kernel, gdims):
    """Each (degree, dtype) a 3D run of the port launches off the fp32 p = 4
    main tile takes a compiled tile of csrc/tiles.cuh at its lattice."""
    plan, name = _kernel_of(gdims, p, dtype, kernel)
    assert name.endswith("compiled"), (name, plan)
