"""The least time the card could take for one RK4 step of a cell, from the
cell's shapes alone: frozen copies of the bound arithmetic of the measured
package's ``tools/bounds.py`` (``floor_ms``, ``stencil_flops``, the peaks)
and the slab correction's operation count, put together for the whole step
so that the floor is the same whatever kernels implement it.

What a step must do, counted once:

* bytes: the state (u0, v0) read once and (u, v) written once. Every other
  operand (the lumped masses, the facet vectors, the DG-0 coefficients, the
  slab's geometry factors) can be worked out from per-cell data a small
  fraction of that size, so none is counted: a floor may count too little,
  never too much;
* operations: four stages, each the stiffness stencil of one field (the two
  fields combined per cell first: K_a u + K_b v = K(a u + b v) for DG-0
  a, b) over the three axes, STAGE_NODE_FLOPS a node for the stage fields,
  facet terms and epilogue; on a bowl-fitted lattice also the per-cell
  correction of the deformed slab, four times.

The floor is the larger of bytes at HBM_BYTES_PER_S and operations at the
fp32 (or fp64) peak.
"""

from __future__ import annotations

import numpy as np

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): device memory
# bytes/s, and fp32 and fp64 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
STAGE_NODE_FLOPS = 16  # per node: the stage fields, facet terms and epilogue


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
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": read + written, "flops": flops}


def slab_flops(slab_cells: int, p: int) -> float:
    """Operations of one per-cell stiffness action on ``slab_cells`` cells:
    three derivative contractions forward and three back (2N a node each),
    and the symmetric G transform (three rows of three products and two
    sums, 15 a node)."""
    N = p + 1
    return float(slab_cells) * N**3 * (12 * N + 15)


def step_floor(gdims, p: int, itemsize: int = 4, slab_cells: int = 0) -> dict:
    """``floor_ms`` of one RK4 step on the node lattice ``gdims`` at degree
    ``p`` with fields of ``itemsize`` bytes, plus the slab correction of
    ``slab_cells`` deformed cells at each stage."""
    nodes = int(np.prod(gdims))
    stage = stencil_flops(gdims, p, 1, (0, 1, 2)) + STAGE_NODE_FLOPS * nodes
    flops = 4 * (stage + slab_flops(slab_cells, p))
    rate = FP64_FLOP_PER_S if itemsize == 8 else FP32_FLOP_PER_S
    return floor_ms(2 * nodes * itemsize, 2 * nodes * itemsize, flops, rate)
