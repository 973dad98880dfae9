"""K1: the packed lattice stiffness, y = Σ_f Σ_a fold_a(F_a^f ∘ K1·unfold_a(x_f)).

Port of ``fenicsxfus_tpu/ops/pallas_v3.py::apply_v3`` (the TPU kernel) and of
the host packing in ``ops/pallas_lattice.py`` (``_k1_matrix``, ``pack_const``,
``pack_field``). The forward/backward derivative pair of ``ops/lattice.py``
contracts into one local matrix K1 = Dᵀ·diag(w)·D [N, N] applied per cell
window, and the coefficient separates as S_a[(c,k), ⊥] = w[k]·F_a[c, ⊥], with
F_a the coefficient folded over the perpendicular axes.

Packed coefficient layout of the port: ``F_a`` has the lattice shape
[G0, G1, G2] with axis a replaced by the cell count n_a (DG-0 coefficient)
or 1 (constant coefficient). The JAX package stores F2 transposed,
[G0, n2, G1]; ``convert.coeff_from_jax`` maps it.

``stiffness_apply`` is the wrapper: a CUDA tensor launches the hand-written
kernel in ``csrc/stiffness.cu`` (the shared-memory tiled stencil of
``csrc/tile.cuh``, shaped by ``tile_plan``); a CPU tensor runs
``stiffness_plain``, the same function in ordinary torch ops.

K4a/K4b: the same operator split at the axis-0 / axes-1,2 boundary into two
kernels (``csrc/stiffness_ab.cu``), the port of the JAX package's two-kernel
``LatticePallasStiffness.apply`` (``_kernel_axis0``, ``_kernel_axes12``).
``stiffness_apply`` takes that path when ``FUS_V3=0``. K4a runs the axis-0
column march of ``csrc/column.cuh`` (``column_plan``) and K4b the in-plane
plane tile of ``csrc/plane.cuh`` (``plane_plan``), the two walks of the
two-kernel stage (``ops/stage_ab.py``), whose plans live here.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os

import numpy as np
import torch

from ..core.gll import diff_matrix, gll_points_weights_01
from ..utils import resolve_device
from .lattice import LatticeStiffness

DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
MAX_DEGREE = 8  # kMaxN - 1 in csrc/lattice.cuh


def k1_matrix(p: int) -> np.ndarray:
    """Local 1D pre-contracted operator K1 = Dᵀ diag(w) D on the unit cell."""
    N = p + 1
    D = diff_matrix(N)
    _, w = gll_points_weights_01(N)
    return D.T @ (w[:, None] * D)


@functools.lru_cache(maxsize=None)
def _k1_tensor(p: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(k1_matrix(p), dtype=dtype, device=device)


# ------------------------------------------------------------------ packing


def pack_const(lat: LatticeStiffness, coeff: float, device="cuda"):
    """Packed F tensors for a spatially constant coefficient (3D)."""
    c = float(coeff)
    wg = [np.asarray(lat._wg[a]) for a in range(3)]
    G0, G1, G2 = lat.gdims
    F0 = (c * lat._geo[0]) * np.outer(wg[1], wg[2]).reshape(1, G1, G2)
    F1 = (c * lat._geo[1]) * (wg[0][:, None, None] * wg[2][None, None, :])
    F2 = (c * lat._geo[2]) * (wg[0][:, None, None] * wg[1][None, :, None])
    return _as_coeff((F0, F1, F2), lat.dtype, device)


def pack_field(lat: LatticeStiffness, coeff_cells: np.ndarray, device="cuda"):
    """Packed F tensors for a DG-0 coefficient field (3D): the coefficient
    folded (weighted) over the perpendicular axes, cell-resolved along the
    contraction axis."""
    c = np.asarray(coeff_cells, np.float64).reshape(lat.grid)
    outs = []
    for a in range(3):
        t = c.copy()
        for b in range(3):
            if b != a:
                t = lat._fold_weighted(t, b)
        outs.append(lat._geo[a] * t)  # cell axis a, lattice elsewhere
    return _as_coeff(outs, lat.dtype, device)


def _as_coeff(Fs, dtype, device):
    device = resolve_device(device)
    return {
        f"F{a}": torch.as_tensor(np.ascontiguousarray(F), dtype=dtype, device=device)
        for a, F in enumerate(Fs)
    }


def coeff_extents(F: dict, gdims, grid) -> tuple[int, int, int]:
    """Cell-axis extent of each packed F_a (n_a or 1), after checking shapes."""
    exts = []
    for a in range(3):
        shape = tuple(F[f"F{a}"].shape)
        e = shape[a] if len(shape) == 3 else 0
        if shape != gdims[:a] + (e,) + gdims[a + 1 :] or e not in (1, grid[a]):
            raise ValueError(
                f"F{a} has shape {shape}; expected the lattice shape "
                f"{gdims} with axis {a} replaced by {grid[a]} or 1"
            )
        exts.append(e)
    return tuple(exts)


def lattice_grid(gdims, p: int) -> tuple[int, int, int]:
    """Cells per axis of a [G0, G1, G2] lattice of degree p."""
    grid = []
    for G in gdims:
        if G < p + 1 or (G - 1) % p:
            raise ValueError(f"lattice extent {G} is not n·{p} + 1")
        grid.append((G - 1) // p)
    return tuple(grid)


# ----------------------------------------------------------------- tile plan

# K1 and K2 run the tiled stencil of csrc/tile.cuh: a block owns a tile of
# (g1, g2) columns, whole cells, one thread per column, and marches along g0
# over a slab of cells. These are the starting sizes, which the plan cuts to
# the lattice, to the shared-memory target and to the card's SM count.
TILE_NODES = (8, 32)  # owned nodes of a tile along g1, g2 at most (tile.cuh kMainT1/T2)
SLAB_CELLS = 8  # cells of a slab along g0
SMEM_TARGET = 72 * 1024  # halve the tile until its shared memory fits
SMEM_MAX = 232_448  # dynamic shared memory a block may have on the H100 (227 KB)
MIN_BLOCKS = 132  # the H100's SMs: below, the plan cuts the slab, then the tile
MAX_THREADS = 512  # threads of a block (csrc/tile.cuh kTileMaxThreads)
LOAD_SLOTS = 2  # nodes of a shared plane one thread loads (csrc/tile.cuh kSlots)
GRID_MAX = 65_535  # blocks along the grid's y and z
ITEMSIZE = {torch.float32: 4, torch.float64: 8}


def tile_smem_bytes(t1: int, t2: int, p: int, nf: int, nr: int, itemsize: int) -> int:
    """Dynamic shared memory of a t1 × t2 tile (csrc/tile.cuh): a ring of the
    N = p + 1 planes of a cell, each of nf fields and nr raw operands
    spanning t + p + 1 nodes per axis, and K1."""
    N = p + 1
    return (N * (nf + nr) * (t1 + p + 1) * (t2 + p + 1) + N * N) * itemsize


def tile_threads(t1: int, t2: int, p: int) -> int:
    """Threads of a t1 × t2 tile (csrc/tile.cuh, csrc/plane.cuh): one per
    column, and enough to load a plane with its halo ``LOAD_SLOTS`` nodes
    each, in whole warps."""
    plane = (t1 + p + 1) * (t2 + p + 1)
    return 32 * -(-max(t1 * t2, -(-plane // LOAD_SLOTS)) // 32)


# The compiled tiles (csrc/tiles.cuh): a kernel with the degree and the tile
# fixed at compile time for each (type, degree, fields or kind) that a 3D
# path of the port launches. degree_tile chooses each tile: from whole
# cells, the halo factor (t1+p+1)(t2+p+1)/(t1 t2) closest to the fp32 p = 4
# main tile's (8 x 32: 1.88), with TILE_MIN_BLOCKS blocks an SM in shared
# memory (SMEM_SM, less SMEM_RESERVED a block) and in registers
# (TILE_REGISTERS a thread: the kernels' __launch_bounds__ hold ptxas to it),
# at most MAX_THREADS threads; ties go to the longer rows along g2, then g1.
TILE_MIN_BLOCKS = 2  # csrc/tile.cuh FixedTile::kMinBlocks
SMEM_SM = 233_472  # shared memory of an H100 SM (228 KB)
SMEM_RESERVED = 1024  # of it, reserved by the runtime for each block
REGISTERS_SM = 65_536
# registers a thread of a compiled tile takes without spilling, by (item
# size, fields, raw operands): K1 with 1 or 2 fields, K2 with 3 or 4 raw
# operands (ptxas, PERF.md)
TILE_REGISTERS = {(4, 1, 1): 136, (4, 2, 2): 200, (4, 1, 3): 136, (4, 2, 4): 168,
                  (8, 1, 1): 168, (8, 2, 2): 200, (8, 1, 3): 168, (8, 2, 4): 200}
MAIN_TILE = (8, 32)  # the fp32 p = 4 main tile (csrc/tile.cuh kMainT1, kMainT2)
# K2's stiffness fields per kind (ops/stage.py): un (coefficient 0) and vn
# (coefficient 1); the raw operands its tile copies per node, by fields: u0,
# v0, kvpp and (two fields) kvp (csrc/stage.cuh StageFields::NR)
KIND_FIELDS = {"linear": 1, "lossy": 2, "westervelt": 2, "focused": 2}
KIND_RAW = {1: 3, 2: 4}
_F32, _F64 = "float32", "float64"
# the entries of csrc/tiles.cuh: ("K1", type, p, fields) and ("K2" or
# "K2+band", type, p, kind)
_K2_DEGREES = ((_F32, 5), (_F32, 6), (_F64, 4), (_F64, 5))  # K2's lists, by (type, p)
COMPILED_TILES = frozenset(
    [("K1", _F32, p, nf) for p in (2, 3, 5, 6) for nf in (1, 2)]
    + [("K1", _F64, p, nf) for p in (2, 3, 4, 5, 6) for nf in (1, 2)]
    + [("K2", dt, p, kind) for dt, p in _K2_DEGREES for kind in KIND_FIELDS]
    + [("K2+band", dt, p, "westervelt") for dt, p in _K2_DEGREES])


def halo_factor(t1: int, t2: int, p: int) -> float:
    """Nodes a t1 × t2 tile loads a plane (its halo included) per node it owns."""
    return (t1 + p + 1) * (t2 + p + 1) / (t1 * t2)


def degree_tile(p: int, nf: int, nr: int, itemsize: int):
    """The compiled tile (t1, t2) of degree p with ``nf`` stencil fields
    formed from ``nr`` raw operands of ``itemsize`` bytes (the rule above),
    or None if no tile of whole cells fits TILE_MIN_BLOCKS blocks an SM."""
    return _degree_tile(int(p), int(nf), int(nr), int(itemsize),
                        TILE_REGISTERS[itemsize, nf, nr], MAX_THREADS)


@functools.lru_cache(maxsize=None)
def _degree_tile(p, nf, nr, itemsize, registers, max_threads):
    target = halo_factor(*MAIN_TILE, 4)
    threads = min(max_threads, 32 * (REGISTERS_SM // (TILE_MIN_BLOCKS * registers) // 32))
    smem = SMEM_SM // TILE_MIN_BLOCKS - SMEM_RESERVED
    best = None
    for c1 in range(1, threads + 1):
        for c2 in range(1, threads // c1 + 1):
            t1, t2 = c1 * p, c2 * p
            if tile_threads(t1, t2, p) > threads or \
                    tile_smem_bytes(t1, t2, p, nf, nr, itemsize) > smem:
                continue
            key = (abs(halo_factor(t1, t2, p) - target), -t2, -t1)
            if best is None or key < best[0]:
                best = (key, (t1, t2))
    return None if best is None else best[1]


def compiled_key(p: int, dtype, kernel):
    """The csrc/tiles.cuh entry of a launch of ``kernel`` (``("K1", nf)``,
    ``("K2", kind)`` or ``("K2+band", kind)``) at degree p in ``dtype``, or
    None if the table has none."""
    key = (kernel[0], str(dtype).split(".")[-1], int(p), kernel[1])
    return key if key in COMPILED_TILES else None


def tile_kernel(plan: dict, p: int, dtype, kernel) -> str:
    """The kernel a launch of ``kernel`` (as ``compiled_key``) on ``plan``
    takes in csrc/ (the mirror of stiffness.cu's and stage_tile.cuh's
    dispatch): the compiled tile of tiles.cuh whose tile the plan is, else
    the fp32 p = 4 main tile (8 × 32, 256 threads; K2 with the band only for
    westervelt), else the general kernel. Returns its name, e.g. "K2 float32
    p=5 focused 10x30 compiled"."""
    fam, what = kernel
    dt = str(dtype).split(".")[-1]
    label = f"{what}f" if fam == "K1" else what
    t1, t2 = plan["tile"]
    shape = (t1, t2, plan["threads"])
    key = compiled_key(p, dtype, kernel)
    if key is not None:
        nf = what if fam == "K1" else KIND_FIELDS[what]
        nr = nf if fam == "K1" else KIND_RAW[nf]
        tile = degree_tile(p, nf, nr, ITEMSIZE[dtype])
        if tile is not None and shape == (*tile, tile_threads(*tile, p)):
            return f"{fam} {dt} p={p} {label} {t1}x{t2} compiled"
    if (dt == _F32 and p == 4 and shape == (*MAIN_TILE, MAIN_TILE[0] * MAIN_TILE[1])
            and (fam != "K2+band" or what == "westervelt")):
        return f"{fam} {dt} p=4 {label} {t1}x{t2} main"
    return f"{fam} {dt} p={p} {label} general"


def tile_plan(gdims, p: int, nf: int, dtype, nr=None, kernel=None) -> dict:
    """The launch shape of the tiled K1/K2 kernels on a [G0, G1, G2] lattice
    of degree p with ``nf`` stencil fields of ``dtype``, formed from ``nr``
    raw operands per node (K1: nr = nf, the default; K2: u0, v0, kvpp and,
    for two fields, kvp). ``kernel`` (as ``compiled_key``) names the
    launch: where csrc/tiles.cuh compiles a tile for it, the lattice holds
    that tile along g1 and g2 and the card gets ``MIN_BLOCKS`` blocks (the
    slab halved as below), the plan is that tile's (``degree_plan``);
    otherwise, and without ``kernel``, the general plan below.

    Returns a dict: ``tile`` (t1, t2), the owned nodes of a tile along g1,
    g2 (whole cells; the last tile of an axis is cut at the lattice's end);
    ``slab``, the cells of a block's march along g0 (the last slab also owns
    plane G0 - 1); ``halo`` (p, 1), the nodes read below and above a tile or
    slab; ``threads`` of a block (one per column, and enough to load a plane
    with ``LOAD_SLOTS`` nodes each); ``smem``, its dynamic shared-memory
    bytes; ``grid`` (tiles along g2, tiles along g1, slabs). The tile starts
    at ``TILE_NODES`` and the slab at ``SLAB_CELLS``, both cut to the
    lattice; the tile is halved until it fits ``SMEM_TARGET``, then the slab
    and the tile are halved while the grid has fewer than ``MIN_BLOCKS``
    blocks. Raises ValueError for a plan a block cannot run."""
    gdims = tuple(int(g) for g in gdims)
    nr = int(nr or nf)
    if kernel is not None and compiled_key(p, dtype, kernel) is not None:
        plan = degree_plan(gdims, p, nf, dtype, nr)
        if plan is not None:
            return plan
    return dict(_tile_plan(gdims, int(p), int(nf), nr, ITEMSIZE[dtype], TILE_NODES, SLAB_CELLS,
                           SMEM_TARGET, MIN_BLOCKS))


def degree_plan(gdims, p: int, nf: int, dtype, nr=None):
    """The plan of ``degree_tile``'s tile on a [G0, G1, G2] lattice (the
    keys of ``tile_plan``): the slab starts at ``SLAB_CELLS`` cells, cut to
    the lattice, and is halved while the grid has fewer than ``MIN_BLOCKS``
    blocks. None where no tile fits, the lattice is narrower than the tile
    along g1 or g2 (in cells), or the grid stays below ``MIN_BLOCKS``."""
    out = _degree_plan(tuple(int(g) for g in gdims), int(p), int(nf), int(nr or nf),
                       ITEMSIZE[dtype], SLAB_CELLS, MIN_BLOCKS)
    return None if out is None else dict(out)


@functools.lru_cache(maxsize=None)
def _degree_plan(gdims, p, nf, nr, itemsize, slab_cells, min_blocks):
    tile = degree_tile(p, nf, nr, itemsize)
    n = lattice_grid(gdims, p)
    if tile is None or tile[0] > n[1] * p or tile[1] > n[2] * p:
        return None
    t1, t2 = tile
    S = min(slab_cells, n[0])
    while np.prod(_grid(gdims, n[0], t1, t2, S)) < min_blocks and S > 1:
        S //= 2
    grid = _grid(gdims, n[0], t1, t2, S)
    if np.prod(grid) < min_blocks or max(grid[1:]) > GRID_MAX:
        return None
    return (("tile", (t1, t2)), ("slab", S), ("halo", (p, 1)),
            ("threads", tile_threads(t1, t2, p)),
            ("smem", tile_smem_bytes(t1, t2, p, nf, nr, itemsize)), ("grid", grid))


def _grid(gdims, n0, t1, t2, S):
    return (-(-gdims[2] // t2), -(-gdims[1] // t1), -(-n0 // S))


@functools.lru_cache(maxsize=None)
def _tile_plan(gdims, p, nf, nr, itemsize, tile_nodes, slab_cells, target, min_blocks):
    n = lattice_grid(gdims, p)
    c1 = min(max(1, tile_nodes[0] // p), n[1])
    c2 = min(max(1, tile_nodes[1] // p), n[2])
    S = min(slab_cells, n[0])
    # halve along g1 first: rows along g2 stay long, for coalesced loads
    while tile_smem_bytes(c1 * p, c2 * p, p, nf, nr, itemsize) > target and c1 * c2 > 1:
        if c1 > 1:
            c1 //= 2
        else:
            c2 //= 2
    while np.prod(_grid(gdims, n[0], c1 * p, c2 * p, S)) < min_blocks and c1 * c2 * S > 1:
        if S > 1:
            S //= 2
        elif c1 > 1:
            c1 //= 2
        else:
            c2 //= 2
    t1, t2 = c1 * p, c2 * p
    smem = tile_smem_bytes(t1, t2, p, nf, nr, itemsize)
    if smem > SMEM_MAX:
        raise ValueError(
            f"a {t1} x {t2} tile at p={p} with {nf} fields of {itemsize} bytes needs {smem} B "
            f"of shared memory; a block may have {SMEM_MAX} B"
        )
    threads = tile_threads(t1, t2, p)
    if threads > MAX_THREADS:
        raise ValueError(f"a {t1} x {t2} tile at p={p} needs {threads} threads; a block may "
                         f"have {MAX_THREADS}")
    grid = _grid(gdims, n[0], t1, t2, S)
    if max(grid[1:]) > GRID_MAX:
        raise ValueError(f"grid {grid} exceeds {GRID_MAX} blocks along y or z")
    return (("tile", (t1, t2)), ("slab", S), ("halo", (p, 1)), ("threads", threads),
            ("smem", smem), ("grid", grid))


def plan_ints(plan: dict) -> ctypes.Array:
    """The plan as the 8 ints of the C entries (csrc/tile.cuh::read_plan):
    t1, t2, slab, threads, smem bytes, grid x, y, z."""
    return (ctypes.c_int * 8)(*plan["tile"], plan["slab"], plan["threads"], plan["smem"],
                              *plan["grid"])


# ------------------------------------------------------- column and plane plans

# The two walks of the split kernels: the axis-0 column march of K4a and K5a
# (csrc/column.cuh) and the in-plane plane tile of K4b and K5b
# (csrc/plane.cuh). These are the starting sizes, which the plans cut to the
# lattice, to the threads and shared memory of a block and to the card's SM
# count (MIN_BLOCKS: below it the plans cut the slab or the run first, then
# the width).
COLUMN_THREADS = 256  # columns of a column-march block, one thread each
COLUMN_SLAB = 8  # cells of a column-march block's march along g0
COLUMN_MAX_THREADS = 512  # csrc/column.cuh kColumnMaxThreads
PLANE_TILE = (8, 32)  # owned nodes of a plane tile along g1, g2 (csrc/plane.cuh kPlaneMainT1/T2)
PLANE_RUN = 16  # g0 planes of a plane-tile block
PLANE_MAX_THREADS = 512  # csrc/plane.cuh kPlaneMaxThreads


def column_plan(gdims, p: int) -> dict:
    """The launch shape of the column march (K4a, K5a) on a [G0, G1, G2]
    lattice of degree p.

    Returns a dict: ``columns``, the (g1, g2) columns of a block, one thread
    each (the flat index g1*G2 + g2, the last block cut at G1*G2); ``slab``,
    the cells of a block's march along g0 (the last slab also owns plane
    G0 - 1; a slab after the first also reads the cell before it);
    ``grid`` (column blocks, slabs). The march keeps its planes in
    registers: no shared memory. ``columns`` starts at ``COLUMN_THREADS``
    and the slab at ``COLUMN_SLAB``, both cut to the lattice; then the slab,
    and after it the columns, are halved while the grid has fewer than
    ``MIN_BLOCKS`` blocks. Raises ValueError for a plan a block cannot run."""
    return dict(_column_plan(tuple(int(g) for g in gdims), int(p), COLUMN_THREADS,
                             COLUMN_SLAB, MIN_BLOCKS, COLUMN_MAX_THREADS))


@functools.lru_cache(maxsize=None)
def _column_plan(gdims, p, threads, slab, min_blocks, max_threads):
    n0 = lattice_grid(gdims, p)[0]
    cols = gdims[1] * gdims[2]
    C = min(threads, 32 * -(-cols // 32))
    S = min(slab, n0)

    def grid(C, S):
        return (-(-cols // C), -(-n0 // S))

    while np.prod(grid(C, S)) < min_blocks and (S > 1 or C > 32):
        if S > 1:
            S //= 2
        else:
            C = 32 * -(-C // 64)
    if C % 32 or not 32 <= C <= max_threads:
        raise ValueError(f"{C} columns a block; a block takes a multiple of 32 up to "
                         f"{max_threads}")
    g = grid(C, S)
    if g[1] > GRID_MAX:
        raise ValueError(f"grid {g} exceeds {GRID_MAX} blocks along y")
    return (("columns", C), ("slab", S), ("grid", g))


def column_plan_ints(plan: dict) -> ctypes.Array:
    """The plan as the 4 ints of the C entries (csrc/column.cuh::read_column_plan):
    columns, slab, grid x, y."""
    return (ctypes.c_int * 4)(plan["columns"], plan["slab"], *plan["grid"])


def plane_smem_bytes(t1: int, t2: int, p: int, nf: int, nr: int, itemsize: int) -> int:
    """Dynamic shared memory of a t1 × t2 plane tile (csrc/plane.cuh): two
    planes of the nf fields and two of their nr raw operands, each spanning
    t + p + 1 nodes per axis, and K1."""
    N = p + 1
    return (2 * (nf + nr) * (t1 + p + 1) * (t2 + p + 1) + N * N) * itemsize


def plane_plan(gdims, p: int, nf: int, dtype, nr=None) -> dict:
    """The launch shape of the plane tile (K4b, K5b) on a [G0, G1, G2]
    lattice of degree p with ``nf`` stencil fields of ``dtype`` formed from
    ``nr`` raw operands per node that take shared planes of their own (the
    default nf; K5b: u0, v0, kvpp and, for two fields, kvp; K4b: 0, its
    fields are its raw operands).

    Returns a dict: ``tile`` (t1, t2), the owned nodes of a tile along g1,
    g2 (whole cells; the last tile of an axis is cut at the lattice's end);
    ``planes``, the g0 planes of a block's run (the last run cut at G0);
    ``halo`` (p, 1), the nodes read below and above a tile; ``threads``;
    ``smem``, the dynamic shared-memory bytes; ``grid`` (tiles along g2,
    tiles along g1, runs). The tile starts at ``PLANE_TILE`` and the run at
    ``PLANE_RUN``, both cut to the lattice; the tile is halved (along g1
    first) until its threads and shared memory fit (``PLANE_MAX_THREADS``,
    ``SMEM_TARGET``), then the run and after it the tile are halved while
    the grid has fewer than ``MIN_BLOCKS`` blocks. Raises ValueError for a
    plan a block cannot run."""
    nr = int(nf if nr is None else nr)
    return dict(_plane_plan(tuple(int(g) for g in gdims), int(p), int(nf), nr,
                            ITEMSIZE[dtype], PLANE_TILE, PLANE_RUN, SMEM_TARGET, MIN_BLOCKS,
                            PLANE_MAX_THREADS))


@functools.lru_cache(maxsize=None)
def _plane_plan(gdims, p, nf, nr, itemsize, tile_nodes, run, target, min_blocks,
                max_threads):
    n = lattice_grid(gdims, p)
    c1 = min(max(1, tile_nodes[0] // p), n[1])
    c2 = min(max(1, tile_nodes[1] // p), n[2])
    R = min(run, gdims[0])

    def grid(c1, c2, R):
        return (-(-gdims[2] // (c2 * p)), -(-gdims[1] // (c1 * p)), -(-gdims[0] // R))

    def fits(c1, c2):
        t1, t2 = c1 * p, c2 * p
        return (tile_threads(t1, t2, p) <= max_threads
                and plane_smem_bytes(t1, t2, p, nf, nr, itemsize) <= target)

    # halve along g1 first: rows along g2 stay long, for coalesced loads
    while not fits(c1, c2) and c1 * c2 > 1:
        if c1 > 1:
            c1 //= 2
        else:
            c2 //= 2
    while np.prod(grid(c1, c2, R)) < min_blocks and c1 * c2 * R > 1:
        if R > 1:
            R //= 2
        elif c1 > 1:
            c1 //= 2
        else:
            c2 //= 2
    t1, t2 = c1 * p, c2 * p
    smem = plane_smem_bytes(t1, t2, p, nf, nr, itemsize)
    if smem > SMEM_MAX:
        raise ValueError(
            f"a {t1} x {t2} plane tile at p={p} with {nf} fields of {itemsize} bytes needs "
            f"{smem} B of shared memory; a block may have {SMEM_MAX} B"
        )
    threads = tile_threads(t1, t2, p)
    if threads > max_threads:
        raise ValueError(f"a {t1} x {t2} plane tile at p={p} needs {threads} threads; a block "
                         f"may have {max_threads}")
    g = grid(c1, c2, R)
    if max(g[1:]) > GRID_MAX:
        raise ValueError(f"grid {g} exceeds {GRID_MAX} blocks along y or z")
    return (("tile", (t1, t2)), ("planes", R), ("halo", (p, 1)), ("threads", threads),
            ("smem", smem), ("grid", g))


def axes12_plan(gdims, p: int, nf: int, dtype) -> dict:
    """K4b's plane plan: no raw operand planes, since its fields are copied
    straight into the planes the sums read (csrc/lattice.cuh
    FieldLoad::kRawIsField)."""
    return plane_plan(gdims, p, nf, dtype, nr=0)


def plane_plan_ints(plan: dict) -> ctypes.Array:
    """The plan as the 8 ints of the C entries (csrc/plane.cuh::read_plane_plan):
    t1, t2, planes, threads, smem bytes, grid x, y, z."""
    return (ctypes.c_int * 8)(*plan["tile"], plan["planes"], plan["threads"], plan["smem"],
                              *plan["grid"])


# ------------------------------------------------------------- plain version


def _axis_apply_plain(x, Fa, a: int, p: int, K1):
    """F_a ∘ K1·unfold_a(x) in the window representation [.., n_a, N]."""
    N = p + 1
    win = x.movedim(a, -1).unfold(-1, N, p)  # [.., n, N(j)]
    z = (win.unsqueeze(-2) * K1).sum(-1)  # z[c, k] = Σ_j K1[k, j] x[c·p + j]
    return z * Fa.movedim(a, -1).unsqueeze(-1)


def _fold(z, a: int, G: int, p: int):
    """Overlap-add of the window representation [.., n, N] onto axis a."""
    n = z.shape[-2]
    y = z.new_zeros(z.shape[:-2] + (G,))
    y[..., : n * p] = z[..., :p].flatten(-2)
    y[..., p::p] += z[..., p]  # node p of cell c is node 0 of cell c+1
    return y.movedim(-1, a)


def _add_axes_plain(y, xs, Fs, p: int, axes):
    """y += the terms of ``axes`` of Σ_f K_{F_f}(x_f), axis by axis, in place."""
    K1 = _k1_tensor(p, y.dtype, y.device)
    for a in axes:
        z = None
        for x, F in zip(xs, Fs):
            t = _axis_apply_plain(x, F[f"F{a}"], a, p, K1)
            z = t if z is None else z + t
        y += _fold(z, a, y.shape[a], p)
    return y


def stiffness_plain(xs, Fs, p: int) -> torch.Tensor:
    """Plain torch version of the K1 kernel: the same function, ordinary ops
    (elementwise products and sums only, so no TF32 path exists)."""
    return _add_axes_plain(torch.zeros_like(xs[0]), xs, Fs, p, (0, 1, 2))


def stiffness_axis0_plain(xs, Fs, p: int) -> torch.Tensor:
    """Plain torch version of the K4a kernel: the axis-0 term of
    Σ_f K_{F_f}(x_f)."""
    return _add_axes_plain(torch.zeros_like(xs[0]), xs, Fs, p, (0,))


def stiffness_axes12_plain(xs, Fs, yA, p: int) -> torch.Tensor:
    """Plain torch version of the K4b kernel: yA + the axis-1 and axis-2
    terms of Σ_f K_{F_f}(x_f), accumulated into ``yA`` in place (as the
    kernel writes its aliased yA) and returned. After ``stiffness_axis0_plain``
    it adds the axes in ``stiffness_plain``'s order."""
    return _add_axes_plain(yA, xs, Fs, p, (1, 2))


# ------------------------------------------------------------------ wrapper


def check_fields(tensors, gdims, dtype, device):
    """Raise unless every tensor is a contiguous ``dtype`` tensor of shape
    ``gdims`` on ``device``."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"tensor of {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(gdims):
            raise ValueError(f"tensor of shape {tuple(t.shape)}, expected {tuple(gdims)}")
        if not t.is_contiguous():
            raise ValueError("tensor is not contiguous")


def check_coeffs(Fs, gdims, grid, dtype, device):
    """Validate packed coefficients; return their cell-axis extents."""
    exts = []
    for F in Fs:
        ext = coeff_extents(F, gdims, grid)
        for a in range(3):
            Fa = F[f"F{a}"]
            if Fa.device != device or Fa.dtype != dtype or not Fa.is_contiguous():
                raise ValueError(
                    f"F{a}: {Fa.dtype} on {Fa.device}, contiguous="
                    f"{Fa.is_contiguous()}; expected contiguous {dtype} on {device}"
                )
        exts.append(ext)
    return exts


def pointer_array(tensors) -> ctypes.Array:
    """Device pointers as a ctypes uint64 array (0 for an absent tensor)."""
    return (ctypes.c_uint64 * len(tensors))(
        *[0 if t is None else t.data_ptr() for t in tensors]
    )


def launch_args(x: torch.Tensor, p: int):
    """(gdims, K1, stream, device index) arguments shared by the C entries."""
    if p > MAX_DEGREE:
        raise ValueError(f"the CUDA kernels take degree p <= {MAX_DEGREE}, got {p}")
    gd = (ctypes.c_longlong * 3)(*x.shape)
    K1 = (ctypes.c_double * ((p + 1) ** 2))(*k1_matrix(p).reshape(-1))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return gd, K1, ctypes.c_void_p(stream), x.device.index


def _check_stiffness(xs, Fs, p: int, name: str):
    """Validate the fields and coefficients of a stiffness kernel; return
    the cell-axis extents of the coefficients."""
    if not 1 <= len(xs) <= 2 or len(xs) != len(Fs):
        raise ValueError(f"{name} takes 1 or 2 fields with one coefficient each")
    x0 = xs[0]
    gdims = tuple(x0.shape)
    if x0.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {x0.dtype}; use float32 or float64")
    if x0.dim() != 3:
        raise ValueError(f"fields must be 3D lattices, got shape {gdims}")
    grid = lattice_grid(gdims, p)
    check_fields(xs, gdims, x0.dtype, x0.device)
    exts = check_coeffs(Fs, gdims, grid, x0.dtype, x0.device)
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {x0.device}")
    return exts


def _launch(entry, name, xs, Fs, exts, p, outs, plan):
    """Launch the C entry ``entry`` of a stiffness kernel on the current
    stream: fields, coefficients and extents, then the device pointers
    ``outs``, the lattice, and ``plan`` (the kernel's plan ints); raise if
    the launch failed."""
    from .._build import library

    lib = library()
    xp = pointer_array(xs)
    Fp = pointer_array([F[f"F{a}"] for F in Fs for a in range(3)])
    ext = (ctypes.c_int * (3 * len(Fs)))(*[e for ex in exts for e in ex])
    gd, K1, stream, dev = launch_args(xs[0], p)
    rc = getattr(lib, entry)(
        DTYPE_CODES[xs[0].dtype], len(xs), xp, Fp, ext,
        *[ctypes.c_void_p(t.data_ptr()) for t in outs], gd, p, K1, *plan, stream, dev,
    )
    check_launch(lib, rc, name)


def check_launch(lib, rc: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.fus_error_string(rc).decode()}")


def stiffness_apply(xs, Fs, p: int) -> torch.Tensor:
    """y = Σ_f K_{F_f}(x_f) for 1 or 2 lattice fields [G0, G1, G2].

    CUDA tensors launch the K1 kernel (``csrc/stiffness.cu``, shaped by
    ``tile_plan``: a compiled tile of ``csrc/tiles.cuh`` where the degree
    and type have one) on the current stream; CPU tensors run
    ``stiffness_plain``. Anything else raises. With
    ``FUS_V3=0`` in the environment (read at every call, as the JAX package's
    ``LatticePallasStiffness.apply`` reads it) the two-kernel path runs
    instead: ``stiffness_axis0_apply`` (K4a), then ``stiffness_axes12_apply``
    (K4b).
    """
    if os.environ.get("FUS_V3", "1") == "0":
        return stiffness_axes12_apply(xs, Fs, stiffness_axis0_apply(xs, Fs, p), p)
    exts = _check_stiffness(xs, Fs, p, "K1 stiffness")
    if xs[0].device.type == "cpu":
        return stiffness_plain(xs, Fs, p)
    y = torch.empty_like(xs[0])
    kernel = ("K1", len(xs))
    plan = tile_plan(xs[0].shape, p, len(xs), xs[0].dtype, kernel=kernel)
    _launch("fus_stiffness_apply", "K1 stiffness", xs, Fs, exts, p, [y], [plan_ints(plan)])
    stiffness_apply.launches += 1
    stiffness_apply.tiles[tile_kernel(plan, p, xs[0].dtype, kernel)] += 1
    return y


def stiffness_axis0_apply(xs, Fs, p: int) -> torch.Tensor:
    """yA = the axis-0 term of Σ_f K_{F_f}(x_f), the first kernel of the
    two-kernel stiffness. CUDA tensors launch K4a (``csrc/stiffness_ab.cu``,
    shaped by ``column_plan``) on the current stream; CPU tensors run
    ``stiffness_axis0_plain``."""
    exts = _check_stiffness(xs, Fs, p, "K4a stiffness")
    if xs[0].device.type == "cpu":
        return stiffness_axis0_plain(xs, Fs, p)
    yA = torch.empty_like(xs[0])  # every node is written
    plan = column_plan(xs[0].shape, p)
    _launch("fus_stiffness_axis0", "K4a stiffness", xs, Fs, exts, p, [yA],
            [column_plan_ints(plan)])
    stiffness_axis0_apply.launches += 1
    return yA


def stiffness_axes12_apply(xs, Fs, yA, p: int) -> torch.Tensor:
    """yA + the axis-1 and axis-2 terms of Σ_f K_{F_f}(x_f), written in place
    into ``yA`` (the TPU kernel's aliased output) and returned: the second
    kernel of the two-kernel stiffness. CUDA tensors launch K4b
    (``csrc/stiffness_ab.cu``, shaped by ``axes12_plan``) on the current
    stream; CPU tensors run ``stiffness_axes12_plain``."""
    exts = _check_stiffness(xs, Fs, p, "K4b stiffness")
    check_fields([yA], tuple(xs[0].shape), xs[0].dtype, xs[0].device)
    if xs[0].device.type == "cpu":
        return stiffness_axes12_plain(xs, Fs, yA, p)
    plan = axes12_plan(xs[0].shape, p, len(xs), xs[0].dtype)
    _launch("fus_stiffness_axes12", "K4b stiffness", xs, Fs, exts, p, [yA, yA],
            [plane_plan_ints(plan)])
    stiffness_axes12_apply.launches += 1
    return yA


# kernel launches of each wrapper (CUDA tensors only); K1's also by the
# kernel each took (``tile_kernel``)
stiffness_apply.launches = 0
stiffness_apply.tiles = collections.Counter()
stiffness_axis0_apply.launches = 0
stiffness_axes12_apply.launches = 0
