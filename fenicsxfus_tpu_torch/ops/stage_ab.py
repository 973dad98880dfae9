"""K5a/K5b: one explicit-RK stage of the wave models split into two kernels,
all four kinds.

Port of ``fenicsxfus_tpu/ops/pallas_stage.py::FusedRKStage`` (``call_A`` /
``_kernel_A``, ``call_B`` / ``_kernel_B`` and ``make_step``), the JAX
package's two-kernel stage, selected there and here by ``FUS_STAGE_V3=0``.
The port's ``ops/stage.py::FusedRKStage`` is the counterpart of the
single-kernel ``FusedRKStageV3`` (K2); this module splits the same stage at
the axis-0 / axes-1,2 boundary:

    K5a  yA  = axis-0 term of K_u(un) [+ K_v(vn)]
    K5b  acc = yA + the axis-1 and axis-2 terms of the same fields; then K2's
         facet terms, epilogue, and kv or the final step update

with un, vn the stage fields of ``ops/stage.py::stage_fields``. For kind
``linear`` K5a forms un alone and reads no kvp (as ``call_A`` drops it);
K5b still reads it, for vn and the step update.

``stage_a_apply``/``stage_b_apply`` are the wrappers: CUDA tensors launch
``csrc/stage_ab.cu``; CPU tensors run ``stage_a_plain``/``stage_b_plain``.
The two kernels walk the lattice each in its own way, and this module
chooses their launch shapes:

* K5a, the column march of ``csrc/column.cuh``: one thread per (g1, g2)
  column, a block a run of ``columns`` columns and a slab of ``slab`` cells
  along g0, the cell's planes in registers (``column_plan``);
* K5b, the plane tile of ``csrc/plane.cuh``: a block owns a (g1, g2) tile of
  whole cells and a run of ``planes`` g0 planes, with one plane of raw
  operands and its halo in shared memory at a time (``plane_plan``).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from .stage import (
    KIND_CODES,
    KIND_FIELDS,
    KIND_RAW,
    FusedRKStage,
    check_stage,
    check_stage_fields,
    stage_fields,
    stage_finish_plain,
    stage_pointers,
)
from .stiffness import (
    DTYPE_CODES,
    GRID_MAX,
    ITEMSIZE,
    MIN_BLOCKS,
    SMEM_MAX,
    SMEM_TARGET,
    check_fields,
    check_launch,
    lattice_grid,
    launch_args,
    stiffness_axes12_plain,
    stiffness_axis0_plain,
    tile_threads,
)

# ---------------------------------------------------------------- the plans

# K5a's column march (csrc/column.cuh) and K5b's plane tile (csrc/plane.cuh):
# the starting sizes, which the plans cut to the lattice, to the threads and
# shared memory of a block and to the card's SM count (MIN_BLOCKS: below it
# the plans cut the slab or the run first, then the width).
COLUMN_THREADS = 256  # columns of a K5a block, one thread each
COLUMN_SLAB = 8  # cells of a K5a block's march along g0
COLUMN_MAX_THREADS = 512  # csrc/column.cuh kColumnMaxThreads
PLANE_TILE = (8, 32)  # owned nodes of a K5b tile along g1, g2 (csrc/plane.cuh kPlaneMainT1/T2)
PLANE_RUN = 16  # g0 planes of a K5b block
PLANE_MAX_THREADS = 512  # csrc/plane.cuh kPlaneMaxThreads


def column_plan(gdims, p: int) -> dict:
    """The launch shape of K5a on a [G0, G1, G2] lattice of degree p.

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
    """The plan as the 4 ints of the C entry (csrc/column.cuh::read_column_plan):
    columns, slab, grid x, y."""
    return (ctypes.c_int * 4)(plan["columns"], plan["slab"], *plan["grid"])


def plane_smem_bytes(t1: int, t2: int, p: int, nf: int, nr: int, itemsize: int) -> int:
    """Dynamic shared memory of a t1 × t2 plane tile (csrc/plane.cuh): two
    planes of the nf fields and two of their nr raw operands, each spanning
    t + p + 1 nodes per axis, and K1."""
    N = p + 1
    return (2 * (nf + nr) * (t1 + p + 1) * (t2 + p + 1) + N * N) * itemsize


def plane_plan(gdims, p: int, nf: int, dtype, nr=None) -> dict:
    """The launch shape of K5b on a [G0, G1, G2] lattice of degree p with
    ``nf`` stencil fields of ``dtype`` formed from ``nr`` raw operands per
    node (u0, v0, kvpp and, for two fields, kvp: the default).

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
    nr = int(nr or KIND_RAW[int(nf)])
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


def plane_plan_ints(plan: dict) -> ctypes.Array:
    """The plan as the 8 ints of the C entry (csrc/plane.cuh::read_plane_plan):
    t1, t2, planes, threads, smem bytes, grid x, y, z."""
    return (ctypes.c_int * 8)(*plan["tile"], plan["planes"], plan["threads"], plan["smem"],
                              *plan["grid"])


def _fields(kind, u0, v0, kvp, kvpp, scal):
    """The stiffness fields of a stage: [un] or [un, vn]."""
    return list(stage_fields(u0, v0, kvp, kvpp, scal[0], scal[1]))[: KIND_FIELDS[kind]]


def stage_a_plain(kind, u0, v0, kvp, kvpp, Fs, scal, p):
    """Plain torch version of the K5a kernel: the axis-0 stiffness term of
    the stage fields. ``scal``: the stage's host floats; K5a reads alpha and
    beta (``scal[:2]``)."""
    return stiffness_axis0_plain(_fields(kind, u0, v0, kvp, kvpp, scal), Fs, p)


def stage_b_plain(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p, final):
    """Plain torch version of the K5b kernel: ``yA`` (left unchanged) plus the
    axis-1 and axis-2 terms of the stage fields, then the rest of the stage
    as ``ops/stage.py::stage_plain``. Returns kv, or (u1, v1) on the final
    stage."""
    un, vn = stage_fields(u0, v0, kvp, kvpp, scal[0], scal[1])
    acc = stiffness_axes12_plain([un, vn][: KIND_FIELDS[kind]], Fs, yA.clone(), p)
    return stage_finish_plain(kind, acc, un, vn, u0, v0, kvp, kvpp, prev, dense, facets,
                              scal, final)


def stage_a_apply(kind, u0, v0, kvp, kvpp, Fs, scal, p):
    """yA of one RK stage of ``kind`` (the first kernel of the two-kernel
    stage). Arguments as ``stage_a_plain``. CUDA tensors launch K5a
    (``csrc/stage_ab.cu``, shaped by ``column_plan``) on the current stream;
    CPU tensors run ``stage_a_plain``."""
    state = [t for t in (u0, v0, kvp, kvpp) if t is not None]
    exts = check_stage_fields(kind, u0, state, Fs, p)
    if len(scal) < 2:
        raise ValueError("scal needs at least [alpha, beta]")
    if u0.device.type == "cpu":
        return stage_a_plain(kind, u0, v0, kvp, kvpp, Fs, scal, p)
    from .._build import library

    lib = library()
    yA = torch.empty_like(u0)  # every node is written
    ptrs, ext = stage_pointers(u0, v0, kvp, kvpp, None, Fs, [], [], (None, None, None, yA), exts)
    gd, K1, stream, dev = launch_args(u0, p)
    plan = column_plan_ints(column_plan(u0.shape, p))
    rc = lib.fus_stage_a(KIND_CODES[kind], DTYPE_CODES[u0.dtype], ptrs, ext, gd, p, K1,
                         (ctypes.c_double * 2)(scal[0], scal[1]), plan, stream, dev)
    check_launch(lib, rc, "K5a stage")
    stage_a_apply.launches[kind] += 1
    return yA


def stage_b_apply(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p, final):
    """kv, or (u1, v1) on the final stage, of one RK stage of ``kind`` from
    its axis-0 partial ``yA`` (the second kernel of the two-kernel stage).
    Arguments as ``ops/stage.py::stage_apply`` plus ``yA``. CUDA tensors
    launch K5b (``csrc/stage_ab.cu``, shaped by ``plane_plan``) on the
    current stream; CPU tensors run ``stage_b_plain``. The final stage writes
    u1/v1 into new buffers, never onto u0/v0, which other blocks of the
    launch are still reading."""
    exts = check_stage(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final)
    check_fields([yA], tuple(u0.shape), u0.dtype, u0.device)
    if u0.device.type == "cpu":
        return stage_b_plain(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p,
                             final)
    from .._build import library

    lib = library()
    if final:
        outs = (None, torch.empty_like(u0), torch.empty_like(v0))
    else:
        outs = (torch.empty_like(u0), None, None)
    ptrs, ext = stage_pointers(u0, v0, kvp, kvpp, prev, Fs, dense, facets, outs + (yA,), exts)
    gd, K1, stream, dev = launch_args(u0, p)
    plan = plane_plan_ints(plane_plan(u0.shape, p, KIND_FIELDS[kind], u0.dtype))
    rc = lib.fus_stage_b(
        KIND_CODES[kind], DTYPE_CODES[u0.dtype], ptrs, ext, gd, p, K1,
        (ctypes.c_double * len(scal))(*scal), len(scal), int(final), plan, stream, dev,
    )
    check_launch(lib, rc, "K5b stage")
    stage_b_apply.launches[kind] += 1
    return outs[0] if not final else (outs[1], outs[2])


# kernel launches per kind (CUDA tensors only)
stage_a_apply.launches = collections.Counter()
stage_b_apply.launches = collections.Counter()


def stage_ab_apply(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final):
    """One RK stage through K5a then K5b, with ``stage_apply``'s signature."""
    yA = stage_a_apply(kind, u0, v0, kvp, kvpp, Fs, scal, p)
    return stage_b_apply(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p, final)


def stage_ab_plain(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final):
    """The plain versions of K5a then K5b, with ``stage_plain``'s signature."""
    yA = stage_a_plain(kind, u0, v0, kvp, kvpp, Fs, scal, p)
    return stage_b_plain(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p, final)


class FusedRKStageAB(FusedRKStage):
    """Explicit-RK step of one model kind built from two launches per stage,
    K5a then K5b. ``make_step`` is ``FusedRKStage.make_step``: the same
    signature, the same host float64 scalars in the same ``scal`` layout
    ([alpha, beta, source coefficients] + the final stage's step weights),
    and ``stage_fn=stage_ab_plain`` runs the plain path on any device."""

    KERNEL = staticmethod(stage_ab_apply)
