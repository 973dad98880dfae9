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
The two kernels walk the lattice each in its own way, on the launch shapes
of ``ops/stiffness.py``, which K4a and K4b walk too:

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
    check_fields,
    check_launch,
    column_plan,
    column_plan_ints,
    launch_args,
    plane_plan,
    plane_plan_ints,
    stiffness_axes12_plain,
    stiffness_axis0_plain,
)

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
    nf = KIND_FIELDS[kind]
    plan = plane_plan_ints(plane_plan(u0.shape, p, nf, u0.dtype, nr=KIND_RAW[nf]))
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
