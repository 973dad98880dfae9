"""K3: one whole explicit RK4 step of the wave models in one launch, all four
kinds, selected by ``FUS_STEP_WAVE=1``.

Port of ``fenicsxfus_tpu/ops/pallas_step_wave.py`` (``try_separate_field``,
``FusedRKStepWave._step_call`` and ``make_step``). The step is the four K2
stages of ``ops/stage.py`` (stage i reads the step state and the slopes
kv_{i-1}, kv_{i-2}; the last one also kv0 and writes the step update), run as
one launch of ``csrc/step_wave.cu``: a persistent grid takes (stage, axis-0
slab, (g1, g2) tile) work items in wavefront order, runs each as the tiled
stencil of K2 (``csrc/tile.cuh``), orders the stages through completion
counters in device memory and keeps the slopes in rings of a few slabs
(``csrc/wave.cuh``); ``wave_plan`` shapes the launch.

For the kinds whose dense operand is inv_m alone (linear, lossy) the model
may pass inv_m separable, ``(a [G0], P [1, G1, G2])`` with inv_m[g] =
a[g0]·P[g1, g2] (``try_separate_field``), and the kernel reads one scalar
per row and one plane instead of a dense field.

Not ported, because they exist only for the TPU: ``_wave_vmem_bytes``,
``_wave_pick_be``, ``FUS_WAVE_BE`` and the VMEM budget behind ``usable()``;
here ``usable()`` is ``nstage == 4``.

``step_wave_apply`` is the wrapper: CUDA tensors launch K3; CPU tensors run
``step_wave_plain`` (four ``stage_plain`` calls).
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from .stage import (
    KIND_CODES,
    KIND_DENSE,
    KIND_FACET,
    KIND_FIELDS,
    KIND_RAW,
    FusedRKStage,
    check_facets,
    check_stage_fields,
    source_coefs,
    stage_plain,
    stage_pointers,
)
from .stiffness import (
    DTYPE_CODES,
    ITEMSIZE,
    SMEM_TARGET,
    TILE_NODES,
    _tile_plan,
    check_fields,
    check_launch,
    launch_args,
)

STAGES = 4
# kinds that may take inv_m separable
SEP_KINDS = tuple(k for k, d in KIND_DENSE.items() if d == ("inv_m",))


def try_separate_field(arr, gdims, tol=None):
    """Host-side rank-1 test of a lattice field: ``arr[i,j,k] == a[i] *
    P[j,k]``. On a uniform box with homogeneous rho the assembled inverse
    lumped mass has exactly this tensor-product structure.

    Returns ``(a, P)`` as float64 ndarrays (``a``: (G0,), ``P``:
    (1, G1, G2)) or None.

    The tolerance scales with the storage dtype of ``arr``: the assembled
    inv_m is quantized to the model dtype, so a tensor-product field deviates
    from rank-1 by a few ulp of that dtype. tol defaults to
    100·eps(arr.dtype): tight enough that a physical perturbation ≫100 ulp is
    rejected, loose enough that quantization is not. The residual is
    evaluated in row blocks of about 64 MB."""
    src = np.asarray(arr)
    if tol is None:
        eps = np.finfo(src.dtype).eps if src.dtype.kind == "f" else np.finfo(np.float64).eps
        tol = 100.0 * float(eps)
    M = src.astype(np.float64, copy=False).reshape(gdims[0], -1)
    if not np.all(np.isfinite(M)):
        return None
    i0 = int(np.argmax(np.abs(M).sum(axis=1)))
    P = M[i0]
    scale = float(P[int(np.argmax(np.abs(P)))])
    if scale == 0.0:
        return None
    P = P / scale
    denom = P @ P
    a = (M @ P) / denom
    mmax = float(np.max(np.abs(M)))
    blk = max(1, (64 << 20) // max(M.shape[1] * 8, 1))
    err = 0.0
    for r0 in range(0, M.shape[0], blk):
        sub = M[r0 : r0 + blk] - a[r0 : r0 + blk, None] * P[None, :]
        err = max(err, float(np.max(np.abs(sub))))
        if err > tol * mmax:
            return None
    return a, P.reshape(1, gdims[1], gdims[2])


def scal_width(kind: str) -> int:
    """Columns of the [4, W] scalar table: the final stage's scal length."""
    return 1 + len(KIND_FACET[kind]) + 2 * STAGES


def is_separable(kind: str, dense) -> bool:
    """Whether ``dense`` is the separable form (a, P) of inv_m."""
    return kind in SEP_KINDS and len(dense) == 2


def step_table(kind: str, tables, dtn: float, srcs) -> np.ndarray:
    """The [4, W] float64 scalar table of one RK4 step of ``kind``: row i
    the scal of stage i as ``FusedRKStage`` forms it ([alpha, beta,
    srcs[i]...]; the last row + [dt·Σb, cu..., db...]), zero-padded to W.
    ``srcs[i]``: the source coefficients of stage i (``source_coefs``)."""
    a_t, b_t, _ = tables
    table = np.zeros((STAGES, scal_width(kind)))
    for i in range(STAGES):
        alpha = a_t[i] * dtn
        beta = (a_t[i] * a_t[i - 1] if i >= 1 else 0.0) * dtn * dtn
        parts = [alpha, beta] + list(srcs[i])
        if i == STAGES - 1:
            cu = [b_t[j + 1] * a_t[j + 1] * dtn * dtn for j in range(STAGES - 1)]
            db = [b_t[j] * dtn for j in range(STAGES)]
            parts += [float(np.sum(b_t)) * dtn] + cu + db
        table[i, : len(parts)] = parts
    return table


def step_wave_plain(kind, u0, v0, scal4, Fs, dense, facets, p, stage_fn=stage_plain):
    """Plain torch version of the K3 kernel: four ``stage_plain`` calls fed
    by the rows of ``scal4`` ([4, W] host floats, row s the scal of stage s
    zero-padded to W). ``dense``: the tensors of ``KIND_DENSE[kind]``, or
    for linear and lossy the separable (a [G0], P [1, G1, G2]) of inv_m,
    used as ``a[:, None, None] * P`` as the kernel does. Returns (u1, v1).
    ``stage_fn=stage_apply`` makes the four stages four K2 launches."""
    if is_separable(kind, dense):
        dense = [dense[0][:, None, None] * dense[1]]
    nscal = 1 + len(KIND_FACET[kind])
    rows = [[float(x) for x in row] for row in scal4]
    kvs = []
    for s in range(STAGES - 1):
        kvp = kvs[s - 1] if s >= 1 else None
        kvpp = kvs[s - 2] if s >= 2 else None
        kvs.append(stage_fn(kind, u0, v0, kvp, kvpp, None, Fs, dense, facets,
                            rows[s][:nscal], p, False))
    return stage_fn(kind, u0, v0, kvs[2], kvs[1], kvs[0], Fs, dense, facets, rows[3], p, True)


def check_step_wave(kind, u0, v0, scal4, Fs, dense, facets, p):
    """Validate the operands of a whole K3 step; return the coefficients'
    cell-axis extents and whether inv_m is separable."""
    exts = check_stage_fields(kind, u0, [u0, v0], Fs, p)
    G0, G1, G2 = u0.shape
    sep = is_separable(kind, dense)
    if sep:
        check_fields([dense[0]], (G0,), u0.dtype, u0.device)
        check_fields([dense[1]], (1, G1, G2), u0.dtype, u0.device)
    elif len(dense) == len(KIND_DENSE[kind]):
        check_fields(dense, tuple(u0.shape), u0.dtype, u0.device)
    else:
        raise ValueError(f"kind {kind!r} takes dense {KIND_DENSE[kind]}"
                         + (" or a separable (a, P) of inv_m" if kind in SEP_KINDS else ""))
    if len(facets) != len(KIND_FACET[kind]):
        raise ValueError(f"kind {kind!r} takes facets {KIND_FACET[kind]}")
    check_facets(facets, u0)
    if np.shape(scal4) != (STAGES, scal_width(kind)):
        raise ValueError(f"scal4 has shape {np.shape(scal4)}, expected "
                         f"{(STAGES, scal_width(kind))}")
    return exts, sep


# ----------------------------------------------------------------- wave plan

# K3's work item is one tile of csrc/tile.cuh (the K1/K2 tile, TILE_NODES,
# halved to SMEM_TARGET as tile_plan does) over a slab of WAVE_SLAB cells; row
# b of the wavefront holds stage s at slab b - WAVE_LAG*s; each slope ring
# holds 3*WAVE_LAG + 1 + RING_SPARE slabs (csrc/wave.cuh: fewer than
# 3*lag + 1 would let a slot be rewritten while a reader remains). The sizes
# are the fastest of tools/wave_variants.py on the H100 (PERF.md): slabs of
# 1, 2, 4 and 8 cells, lags of 1-3 slabs, rings of 7-12.
WAVE_SLAB = 4
WAVE_LAG = 2
RING_SPARE = 1


def min_ring(lag: int) -> int:
    """The fewest slabs a slope ring may hold at a lag of ``lag`` slabs
    between stages, unless it holds the whole lattice (csrc/wave.cuh)."""
    return 3 * lag + 1


def wave_plan(gdims, p: int, nf: int, dtype, nr=None, blocks: int = 0) -> dict:
    """The launch shape of K3 on a [G0, G1, G2] lattice of degree p with
    ``nf`` stencil fields of ``dtype`` formed from ``nr`` raw operands.

    Returns ``tile_plan``'s keys for the item's tile and slab (``tile``,
    ``slab`` = cells of an item along g0, ``halo``, ``threads``, ``smem``,
    ``grid`` = (tiles along g2, tiles along g1, slabs)) and ``lag`` (rows of
    the wavefront between stages), ``ring`` (slabs R of each slope ring, cut
    to the slab count), ``ring_planes`` (R·slab·p + 1 lattice planes per
    ring), ``blocks`` (of the persistent grid; 0: as many as can be
    resident). The tile is not cut for the block count: the grid is
    persistent. Raises ValueError for a ring below ``min_ring(lag)`` or a
    plan a block cannot run."""
    lag, ring = int(WAVE_LAG), min_ring(int(WAVE_LAG)) + int(RING_SPARE)
    if lag < 1:
        raise ValueError(f"the wavefront needs a lag of at least 1 slab, got {lag}")
    if ring < min_ring(lag):
        raise ValueError(f"a slope ring of {ring} slabs at lag {lag} would be rewritten while "
                         f"a reader remains; it needs at least {min_ring(lag)}")
    if int(blocks) != blocks or blocks < 0:
        raise ValueError(f"blocks must be a block count >= 0, got {blocks}")
    gdims = tuple(int(g) for g in gdims)
    plan = dict(_tile_plan(gdims, int(p), int(nf), int(nr or nf), ITEMSIZE[dtype], TILE_NODES,
                           int(WAVE_SLAB), SMEM_TARGET, 1))
    nslab = plan["grid"][2]
    ring = min(ring, nslab)
    return dict(plan, lag=lag, ring=ring, ring_planes=ring * plan["slab"] * int(p) + 1,
                blocks=int(blocks))


def wave_plan_ints(plan: dict) -> ctypes.Array:
    """The plan as the 11 ints of the C entry (csrc/wave.cuh::read_wave_plan):
    t1, t2, slab, threads, smem bytes, grid x, y, z, lag, ring, blocks."""
    return (ctypes.c_int * 11)(*plan["tile"], plan["slab"], plan["threads"], plan["smem"],
                               *plan["grid"], plan["lag"], plan["ring"], plan["blocks"])


def ring_planes(plan: dict, G0: int, p: int) -> np.ndarray:
    """Where each lattice plane g0 of a slope lies in its ring (csrc/wave.cuh):
    slab Z's plane g0 at (Z mod R)·S·p + g0 − Z·S·p, and plane G0 − 1 (the
    last slab's extra plane) at R·S·p; int32, one entry per plane."""
    sp, R = plan["slab"] * int(p), plan["ring"]
    g0 = np.arange(int(G0))
    Z = g0 // sp
    out = (Z % R) * sp + g0 - Z * sp
    out[-1] = R * sp
    return out.astype(np.int32)


_RING_TABLES: dict = {}


def _ring_table(plan: dict, G0: int, p: int, device) -> torch.Tensor:
    """``ring_planes`` on the device, kept per device and plan."""
    key = (device, G0, p, plan["slab"], plan["ring"])
    table = _RING_TABLES.get(key)
    if table is None:
        table = _RING_TABLES[key] = torch.as_tensor(ring_planes(plan, G0, p), device=device)
    return table


def ring_bytes(plan: dict, gdims, dtype) -> int:
    """Device bytes of the three slope rings of a plan."""
    return 3 * plan["ring_planes"] * int(gdims[1]) * int(gdims[2]) * ITEMSIZE[dtype]


# ------------------------------------------------------ the sticky error word
#
# A dependency wait of the kernel that exceeds its bound sets a per-device
# error word that no launch zeroes; every later launch then stops at once.
# After each launch the wrapper copies the word to pinned host memory behind
# an event, and reads the copies of earlier launches as their events
# complete, waiting for one only when more than MAX_LAG are pending: a
# stuck wait raises within a few launches and the host never stalls the
# card on every step. ``step_wave_check`` waits for all of them.

MAX_LAG = 2
_ERROR_WORDS: dict = {}
_PENDING: collections.deque = collections.deque()


def _error_word(device) -> torch.Tensor:
    word = _ERROR_WORDS.get(device)
    if word is None:
        word = _ERROR_WORDS[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return word


def _poll_errors(block: bool) -> None:
    while _PENDING and (block or len(_PENDING) > MAX_LAG or _PENDING[0][0].query()):
        event, host = _PENDING.popleft()
        event.synchronize()
        if int(host[0]) != 0:
            _PENDING.clear()
            for word in _ERROR_WORDS.values():
                word.zero_()
            raise RuntimeError("K3 step wave: a dependency wait exceeded its bound "
                               f"(error word {int(host[0])}); the step's outputs are invalid")


def step_wave_check() -> None:
    """Wait for every K3 launch issued so far; raise if one of them gave up
    a dependency wait."""
    _poll_errors(block=True)


def step_wave_apply(kind, u0, v0, scal4, Fs, dense, facets, p, grid=0):
    """One RK4 step of ``kind`` on lattice fields [G0, G1, G2]: (u0, v0) ->
    (u1, v1), in new buffers. Arguments as ``step_wave_plain``; ``grid``:
    blocks of the launch (0: as many as can be resident; any count gives
    the same result). CUDA tensors launch K3 (``csrc/step_wave.cu``, shaped
    by ``wave_plan``) on the current stream, its slopes in three rings of
    ``wave_plan``'s size (no field-sized slope buffer); CPU tensors run
    ``step_wave_plain``."""
    exts, sep = check_step_wave(kind, u0, v0, scal4, Fs, dense, facets, p)
    nf = KIND_FIELDS[kind]
    plan = wave_plan(u0.shape, p, nf, u0.dtype, nr=KIND_RAW[nf], blocks=grid)
    if u0.device.type == "cpu":
        return step_wave_plain(kind, u0, v0, scal4, Fs, dense, facets, p)
    from .._build import library

    lib = library()
    _poll_errors(block=False)
    rings = torch.empty((3, plan["ring_planes"]) + tuple(u0.shape[1:]), dtype=u0.dtype,
                        device=u0.device)
    outs = (None, torch.empty_like(u0), torch.empty_like(v0))
    ptrs, ext = stage_pointers(u0, v0, *rings, Fs, dense, facets, outs, exts)
    workspace = torch.empty(1 + STAGES * plan["grid"][2], dtype=torch.int32, device=u0.device)
    table = _ring_table(plan, u0.shape[0], p, u0.device)
    err = _error_word(u0.device)
    gd, K1, stream, dev = launch_args(u0, p)
    scal = np.ascontiguousarray(scal4, dtype=np.float64)
    rc = lib.fus_step_wave(
        KIND_CODES[kind], DTYPE_CODES[u0.dtype], ptrs, ext, gd, p, K1,
        scal.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), scal.shape[1], int(sep),
        wave_plan_ints(plan), ctypes.c_void_p(table.data_ptr()),
        ctypes.c_void_p(workspace.data_ptr()), ctypes.c_void_p(err.data_ptr()), stream, dev,
    )
    check_launch(lib, rc, "K3 step wave")
    step_wave_apply.launches[kind] += 1
    host = torch.empty(1, dtype=torch.int32, pin_memory=True)
    host.copy_(err, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    _PENDING.append((event, host))
    return outs[1], outs[2]


# kernel launches per kind (CUDA tensors only)
step_wave_apply.launches = collections.Counter()


class FusedRKStepWave(FusedRKStage):
    """RK4 step of one model kind in one K3 launch per step."""

    KERNEL = staticmethod(step_wave_apply)

    def usable(self) -> bool:
        return self.nstage == STAGES

    def scalars(self, consts, t: float, dtn: float) -> np.ndarray:
        """``step_table`` of the step that starts at host time ``t``."""
        srcs = [source_coefs(self.kind, consts, t + c * dtn) for c in self.c_tab]
        return step_table(self.kind, (self.a_tab, self.b_tab, self.c_tab), dtn, srcs)

    def make_step(self, consts_to_Fs, consts_to_extras, stage_fn=None):
        """Step function (consts, (u, v, t), dt) -> (u, v, t + dt) on lattice
        tensors [G0, G1, G2], one call of ``stage_fn`` per step: by default
        the class's kernel (``step_wave_apply``), or ``step_wave_plain`` to
        run the plain path on any device. ``consts_to_extras(consts)``: (dense,
        packed facets), dense in ``KIND_DENSE`` order or, for linear and
        lossy, the separable (a, P) of inv_m."""
        if not self.usable():
            raise ValueError("the wave step takes a four-stage RK table")
        step_fn = stage_fn or self.KERNEL
        kind, p = self.kind, self.p

        def step(consts, carry, dtn):
            u0, v0, t = carry
            dense, facets = consts_to_extras(consts)
            u1, v1 = step_fn(kind, u0, v0, self.scalars(consts, t, dtn), consts_to_Fs(consts),
                             dense, facets, p)
            return u1, v1, t + dtn

        step.carry_shape = self.gdims
        return step
