"""K6: the deformed-slab stiffness correction of the hybrid (bowl) path.

Port of ``fenicsxfus_tpu/ops/operators.py`` ``band_correction_rows``
(``_band_gather_rows``, ``stiffness_cells``, ``_band_scatter_rows``). A
bowl-fitted lattice (``core/bowl.py``) is deformed only in its first ``bx``
x-layers of cells, the slab; its stiffness splits as

    K = K_uniform(whole lattice) + K_{c·(G_cell − G_uniform)}(slab)

(the per-cell action is linear in the geometry factors G). The first term is
K1 (``ops/stiffness.py``), or K2's own stencil on the fused step; this module
computes the second on the slab's lattice rows [slab_x, G1, G2],
slab_x = bx·p + 1:

* ``band_gather_rows``: rows → the slab's cells [nb, N, N, N], as strided
  views (``Tensor.unfold`` along each axis: a cell's window of N nodes
  every p nodes);
* ``stiffness_cells``: the sum-factorised per-cell action with the
  correction factors (reference ``cpp/fenicsx-sf/common/spectral_op.hpp:
  173-243``), ``torch.einsum`` with the 1D derivative matrix D [N, N];
* ``band_scatter_rows``: the exact transpose of the gather, a deterministic
  fold per axis (a strided copy of each cell's first p nodes, then a strided
  add of each cell's last node onto the next cell's first);
* ``band_correction_rows``: the three in sequence, with the per-cell
  coefficients of each field.

The JAX package moves slab data with 0/1 window and fold matrices on the
TPU's matrix unit; here the windows are views and the fold two strided
passes, with no index tables and no atomics, so a run repeats bit for bit.
The correction factors are stored component-major, [6, nb, N, N, N] (the
JAX package's [nb, N, N, N, 6] would make every component a strided read of
the whole tensor). K6 is not a port of a Pallas kernel (the JAX package
runs it in XLA): it stays PyTorch ops on any device.
"""

from __future__ import annotations

import torch

from ..analysis.timing import span


def band_gather_rows(t: torch.Tensor, blocks, p: int) -> torch.Tensor:
    """Slab lattice rows [slab_x, G1, G2] → the slab's cells [nb, N, N, N]
    (cells in lattice order, axis 0 slowest; nodes tensor-lex): a view of
    overlapping windows, copied once by the caller's product."""
    N = p + 1
    b0, b1, b2 = blocks
    if tuple(t.shape) != (b0 * p + 1, b1 * p + 1, b2 * p + 1):
        raise ValueError(f"slab rows of shape {tuple(t.shape)} do not fit cells {blocks}, p={p}")
    return t.unfold(0, N, p).unfold(1, N, p).unfold(2, N, p)  # [b0, b1, b2, N, N, N]


def _fold_pair(z: torch.Tensor, dim: int, p: int) -> torch.Tensor:
    """Fold the (cell, node) dimension pair [n, N] at ``dim``, ``dim + 1``
    onto the n·p + 1 lattice nodes of that axis: node k of cell c lands on
    c·p + k, the last node of cell c adding onto the first of cell c + 1."""
    zm = z.movedim((dim, dim + 1), (-2, -1))
    n = zm.shape[-2]
    out = zm.new_empty(zm.shape[:-2] + (n * p + 1,))
    out[..., : n * p] = zm[..., :p].flatten(-2)
    out[..., n * p] = 0
    out[..., p::p] += zm[..., p]
    return out.movedim(-1, dim)


def band_scatter_rows(yc: torch.Tensor, blocks, p: int) -> torch.Tensor:
    """The slab's cells [nb, N, N, N] → their sum on the slab lattice rows
    [slab_x, G1, G2]: the transpose of ``band_gather_rows``, axis 2 first,
    then 1, then 0."""
    N = p + 1
    b0, b1, b2 = blocks
    t = yc.reshape(b0, b1, b2, N, N, N).permute(0, 3, 1, 4, 2, 5)  # [b0, N, b1, N, b2, N]
    t = _fold_pair(t, 4, p)  # [b0, N, b1, N, G2]
    t = _fold_pair(t, 2, p)  # [b0, N, G1, G2]
    return _fold_pair(t, 0, p).contiguous()  # [slab_x, G1, G2]


def stiffness_cells(D: torch.Tensor, G: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Sum-factorised per-cell stiffness action y_c = Bᵀ(G_c ∘ B z_c) on
    the cells ``z`` [nc, N, N, N], with ``G`` [6, nc, N, N, N] the symmetric
    factors (00, 01, 02, 11, 12, 22) at the GLL nodes and ``D`` [N, N] the
    1D derivative matrix (port of ``fenicsxfus_tpu/ops/operators.py::
    stiffness_cells``, 3D)."""
    d0 = torch.einsum("qi,cijk->cqjk", D, z)
    d1 = torch.einsum("qj,cijk->ciqk", D, z)
    d2 = torch.einsum("qk,cijk->cijq", D, z)
    g0 = G[0] * d0 + G[1] * d1 + G[2] * d2
    g1 = G[1] * d0 + G[3] * d1 + G[4] * d2
    g2 = G[2] * d0 + G[4] * d1 + G[5] * d2
    return (
        torch.einsum("qi,cqjk->cijk", D, g0)
        + torch.einsum("qj,ciqk->cijk", D, g1)
        + torch.einsum("qk,cijq->cijk", D, g2)
    )


def band_correction_rows(rows, coeffs, G: torch.Tensor, D: torch.Tensor, blocks,
                         p: int) -> torch.Tensor:
    """K_{Σ_f coeff_f·(G_cell − G_uniform)} on the slab rows: ``rows`` the
    fields' slab rows [slab_x, G1, G2] (one or two), ``coeffs`` each field's
    per-cell coefficient on the slab [nb]; returns the correction on the
    same rows."""
    N = p + 1
    z = None
    with span("fus.band.gather"):
        for t, cb in zip(rows, coeffs):
            zc = band_gather_rows(t, blocks, p) * cb.view(*blocks, 1, 1, 1)
            z = zc if z is None else z + zc
    with span("fus.band.cells"):
        yc = stiffness_cells(D, G, z.reshape(-1, N, N, N))
    with span("fus.band.scatter"):
        return band_scatter_rows(yc, blocks, p)
