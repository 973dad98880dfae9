"""The least time the card could take for a kernel's work: the bytes it must
move (each input read once, each output written once) over the H100's
memory rate, or its operations over the peak rate of their type, whichever
is larger. ``chip_smoke.py`` and the speed tools (``operator_speed.py``,
``stage_attrib.py``, ``solver_speed.py``, ``hybrid_speed.py``,
``phase_breakdown.py``, ``unstructured_speed.py``) report every timing beside
this bound and its share of it.
"""

from __future__ import annotations

import numpy as np

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): device memory
# bytes/s, and fp32 and fp64 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
STAGE_NODE_FLOPS = 16  # per node: the stage fields, facet terms and epilogue


def nbytes(*objs) -> int:
    """Bytes of the tensors in ``objs`` (nested in lists and dicts; None is
    absent)."""
    total = 0
    for o in objs:
        if isinstance(o, dict):
            total += nbytes(*o.values())
        elif isinstance(o, (list, tuple)):
            total += nbytes(*o)
        elif o is not None:
            total += o.numel() * o.element_size()
    return total


def stencil_flops(gdims, p: int, nf: int, axes) -> float:
    """Floating-point operations of the stiffness stencil of ``nf`` fields
    over ``axes``: per node and axis, 2N per cell holding the node (two at
    an interface) plus the coefficient product."""
    nodes = float(np.prod(gdims))
    flops = 0.0
    for a in axes:
        n = (gdims[a] - 1) // p
        flops += nodes * nf * (2 * (p + 1) + 1) * (1.0 + (n - 1) / gdims[a])
    return flops


def floor_ms(read: int, written: int, flops: float, flop_rate: float = FP32_FLOP_PER_S) -> dict:
    """The least time the card could take for a call that reads ``read``
    bytes once, writes ``written`` bytes once and does ``flops`` operations
    at ``flop_rate`` (fp32 unless given): the larger of the two times, and
    which one it is."""
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def share_text(bound: dict, ms: float) -> str:
    """The bound of a timed call and its share of the call's time."""
    return (f"bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}), bound/ms "
            f"{bound['bound_ms'] / ms:.3f}")


def stage_floor(args: dict, kernel: str) -> dict:
    """``floor_ms`` of one call of stage kernel ``kernel`` (K2, K5a or K5b)
    on the operands ``args`` (``stage_apply``'s keyword arguments): the
    tensors that kernel reads, each once, and what it writes."""
    from ..ops.stage import KIND_FIELDS

    nf = KIND_FIELDS[args["kind"]]
    gd, p, u0 = tuple(args["u0"].shape), args["p"], args["u0"]
    nodes = float(np.prod(gd))
    if kernel == "K5a":  # u0, v0, kvp (two-field kinds), kvpp, F0 -> yA
        kvp = args["kvp"] if nf > 1 else None
        read = nbytes(u0, args["v0"], kvp, args["kvpp"], [F["F0"] for F in args["Fs"]])
        return floor_ms(read, nbytes(u0), stencil_flops(gd, p, nf, (0,)) + 3 * nf * nodes)
    state = nbytes(u0, args["v0"], args["kvp"], args["kvpp"], args["prev"], args["dense"],
                   args["facets"])
    band = args.get("band")  # K2's band operand, if any: read once, one add a node
    if kernel == "K2":
        read, axes = state + nbytes(args["Fs"], band), (0, 1, 2)
    else:  # K5b: + yA, F1 and F2
        read = state + nbytes(u0, [[F["F1"], F["F2"]] for F in args["Fs"]])
        axes = (1, 2)
    written = nbytes(u0) * (2 if args["final"] else 1)
    flops = stencil_flops(gd, p, nf, axes) + STAGE_NODE_FLOPS * nodes
    return floor_ms(read, written, flops + (0 if band is None else band.numel()))


def general_bounds(ops) -> dict:
    """The floor of each part of a general (per-cell) apply of one field on
    ``ops`` in its dtype: bytes read once and written once, or operations
    at the peak rate, whichever is larger. The index maps count as input."""
    nc, nd, n, nf = ops.num_cells, ops.N**ops.d, ops.N, ops.ndofs  # 3D: N^3 nodes = points
    f = np.dtype(str(ops.dtype).replace("torch.", "")).itemsize
    rate = FP64_FLOP_PER_S if f == 8 else FP32_FLOP_PER_S
    i4, i8 = 4, 8
    cells = f * nc * nd
    g_bytes = f * 6 * nc * nd
    tf = 3 * (1 + 2 * 2) * nc * nd  # the symmetric-G transform: 3 rows of mul, fma, fma
    dense_ops = 2 * (2 * nc * nd * 3 * nd) + tf
    sum_ops = 2 * 3 * 2 * n * nc * nd + tf
    return {
        "gather": floor_ms(f * nf + i4 * nc * nd, cells, 0, rate),
        "dense": floor_ms(cells + g_bytes + f * 3 * nd * nd, cells, dense_ops, rate),
        "sum-factorised": floor_ms(cells + g_bytes, cells, sum_ops, rate),
        "K_ref": floor_ms(cells + f * nd * nd, cells, 2 * nc * nd * nd, rate),
        "scatter": floor_ms(cells + i4 * nc * nd + i8 * nf, f * nf, nc * nd, rate),
        "scatter_segsum": floor_ms(cells + i8 * nc * nd + i8 * nf, f * nf, nc * nd, rate),
        "apply": floor_ms(f * nf + i4 * nc * nd + f * nc + g_bytes + i4 * nc * nd + i8 * nf,
                          f * nf, dense_ops, rate),
    }
