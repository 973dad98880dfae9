"""Lattice stiffness on uniform axis-aligned structured meshes.

Port of ``fenicsxfus_tpu/ops/lattice.py::LatticeStiffness``. DOFs live on the
global GLL lattice [G0, .., G_{d-1}], Ga = na·p + 1, and on an axis-aligned
uniform mesh the stiffness is index-free:

    K u = Σ_a  B_aᵀ ( S_a ∘ (B_a u) )

with B_a the cell unfold + 1D reference derivative along axis a and S_a the
GLL weights, geometry and coefficient folded onto the mixed representation
[.., na·N, ..] (axis-aligned ⇒ no cross-axis terms).

This module holds the host-side (numpy) setup — folded weights, geometry
factors, the lumped-mass and stiffness diagonals, scale tensors of a
constant, a DG-0 and a nodal coefficient (``scales_nodal``, the sponge's
δ(x)) — and ``apply_scaled``, a d-generic plain torch version of the
formula above.
``apply_scaled`` is the oracle that the packed K1 form
(``ops/stiffness.py``) is held against, written from D, w and S
separately, not from K1 and the packed F tensors; on 1D and 2D lattices,
which have no kernel (the JAX package runs them through its own
``apply_scaled`` too), it is the stiffness itself.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.gll import diff_matrix, gll_points_weights_01


def numpy_dtype(dtype: torch.dtype):
    """Host dtype used for one-time assembly in the device dtype."""
    return np.float32 if dtype == torch.float32 else np.float64


@functools.lru_cache(maxsize=None)
def _diff_tensor(N: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The GLL derivative matrix D [N, N] on a device, made once (a copy
    from the host at every apply would wait for the device)."""
    return torch.as_tensor(diff_matrix(N), dtype=dtype, device=device)


def _folded_weights(n_cells: int, p: int) -> np.ndarray:
    """Assembled 1D GLL weights on the global lattice [G] (interface nodes
    accumulate the endpoint weight from both neighbouring cells)."""
    N = p + 1
    _, w = gll_points_weights_01(N)
    G = n_cells * p + 1
    out = np.zeros(G)
    for c in range(n_cells):
        out[c * p : c * p + N] += w
    return out


class LatticeStiffness:
    """Stiffness data on a uniform axis-aligned structured mesh.

    Parameters
    ----------
    grid : cells per axis, e.g. (nx, ny, nz)
    degree : polynomial degree p
    h : cell extents per axis
    dtype : torch dtype of the device fields
    """

    def __init__(self, grid, degree: int, h, dtype=torch.float64):
        self.grid = tuple(int(g) for g in grid)
        self.d = len(self.grid)
        self.p = degree
        self.N = degree + 1
        self.h = tuple(float(x) for x in h)
        self.dtype = dtype
        self.gdims = tuple(g * degree + 1 for g in self.grid)
        _, w1 = gll_points_weights_01(self.N)
        self._w1 = w1
        self._wg = [_folded_weights(self.grid[a], degree) for a in range(self.d)]
        # detJ / h_a^2 factor per axis: prod(h) / h_a^2
        vol = float(np.prod(self.h))
        self._geo = [vol / (self.h[a] ** 2) for a in range(self.d)]

    # ------------------------------------------------------------- scales
    def scales_const(self, coeff: float):
        """Rank-1 scale factors for a spatially constant coefficient:
        per axis (scalar, [1D vector per axis]) to broadcast-multiply."""
        out = []
        for a in range(self.d):
            vecs = []
            for b in range(self.d):
                if b == a:
                    v = np.tile(self._w1, self.grid[a])  # [na*N]
                else:
                    v = self._wg[b]  # [Gb]
                vecs.append(v)
            out.append((float(coeff) * self._geo[a], vecs))
        return out

    def scales_field(self, coeff_cells: np.ndarray):
        """Full scale tensor per axis for a DG-0 coefficient field (numpy).

        S_a[.., (c_a,k_a), ..] = geo_a * w_k * fold_{b≠a}(coeff ⊗ w_b)
        Shape: gdims with axis a replaced by n_a*N.
        """
        c = np.asarray(coeff_cells, np.float64).reshape(self.grid)
        N = self.N
        out = []
        for a in range(self.d):
            t = np.repeat(c, N, axis=a)  # cell value at each (cell, node)
            wa = np.tile(self._w1, self.grid[a])
            shape = [1] * self.d
            shape[a] = self.grid[a] * N
            t = t * wa.reshape(shape)
            for b in range(self.d):
                if b != a:
                    t = self._fold_weighted(t, b)
            out.append(self._geo[a] * t)
        return out

    def _fold_weighted(self, t: np.ndarray, axis: int, w=None) -> np.ndarray:
        """Cell-axis → weighted global lattice fold along ``axis``:
        out[g] = Σ_{cells c ∋ g} w_{local(g,c)} · t[c]."""
        n, p, N = self.grid[axis], self.p, self.N
        w = (self._w1 if w is None else np.asarray(w)).astype(t.dtype)
        tm = np.moveaxis(t, axis, 0)  # [n, ...]
        G = n * p + 1
        out = np.zeros((G,) + tm.shape[1:], t.dtype)
        for k in range(N):
            out[k::p][:n] += w[k] * tm  # node k of each cell sits at c*p+k
        return np.moveaxis(out, 0, axis)

    def scales_nodal(self, coeff_lattice: np.ndarray) -> tuple:
        """Full scale tensor per axis (numpy) for a coefficient given at the
        GLL *nodes* (the sponge layer's δ(x), reference
        ``_experimental.py:770-780``): evaluated at each (collocated)
        quadrature point, the coefficient factors out of the cross-axis
        folds and multiplies the mixed-representation weight pattern
        pointwise. A tuple of one array per axis, each the lattice shape
        with axis a replaced by n_a·N (never the rank-1 (scalar, vectors)
        form of ``scales_const``)."""
        c = np.asarray(coeff_lattice, np.float64).reshape(self.gdims)
        out = []
        for a in range(self.d):
            t = self._unfold(c, a)  # [.., na*N, ..]
            wa = np.tile(self._w1, self.grid[a])
            shape = [1] * self.d
            shape[a] = self.grid[a] * self.N
            t = t * wa.reshape(shape)
            for b in range(self.d):
                if b == a:
                    continue
                shape = [1] * self.d
                shape[b] = self.gdims[b]
                t = t * self._wg[b].reshape(shape)
            out.append(self._geo[a] * t)
        return tuple(out)

    def _unfold(self, t: np.ndarray, axis: int) -> np.ndarray:
        """Global lattice → (cell, node) expansion along ``axis`` (the
        overlapping-window inverse of ``_fold_weighted`` without weights)."""
        n, p, N = self.grid[axis], self.p, self.N
        tm = np.moveaxis(t, axis, 0)
        out = np.zeros((n * N,) + tm.shape[1:])
        for k in range(N):
            out[k::N] = tm[k::p][:n]
        return np.moveaxis(out, 0, axis)

    def mass_diag_nodal(self, coeff_lattice) -> np.ndarray:
        """Lumped mass with a nodal coefficient: m[g] = coeff[g] · m_unit[g]
        (collocation ⇒ the nodal value factors out of the cell sum)."""
        base = self.mass_diag(1.0)
        return np.asarray(coeff_lattice, np.float64).reshape(-1) * base

    def mass_diag(self, coeff_cells) -> np.ndarray:
        """Assembled lumped-mass diagonal on the lattice (host, numpy):
        m[g] = Σ_{cells c ∋ g} coeff_c · w_i w_j w_k · detJ.  Returns the
        flat [ndofs] vector. Folds run in the device dtype."""
        npdt = numpy_dtype(self.dtype)
        arr = np.asarray(coeff_cells, npdt)
        if arr.ndim == 0:
            arr = np.full(self.grid, arr, npdt)
        t = arr.reshape(self.grid) * npdt(np.prod(self.h))
        for a in range(self.d):
            t = self._fold_weighted(t, a)
        return t.reshape(-1)

    def stiffness_diag(self, coeff_cells) -> np.ndarray:
        """Assembled stiffness diagonal on the lattice (host, numpy):
        per cell diag(K)_((i,j,k)) = Σ_a geo_a · d2[i_a] · Π_{b≠a} w_{i_b}
        with d2[n] = Σ_q w_q D[q,n]² (axis-aligned ⇒ no off-diagonal G),
        folded index-free onto the lattice (O(ndofs) memory). Returns the
        flat [ndofs] vector. Folds run in the device dtype."""
        npdt = numpy_dtype(self.dtype)
        arr = np.asarray(coeff_cells, npdt)
        if arr.ndim == 0:
            arr = np.full(self.grid, arr, npdt)
        arr = arr.reshape(self.grid)
        D = diff_matrix(self.N)
        d2 = (self._w1[:, None] * D**2).sum(axis=0)  # [N]
        out = np.zeros(self.gdims, npdt)
        for a in range(self.d):
            t = arr * npdt(self._geo[a])
            for b in range(self.d):
                t = self._fold_weighted(t, b, w=(d2 if b == a else None))
            out += t
        return out.reshape(-1)

    # -------------------------------------------------------------- apply

    def _scale_tensor(self, scales_a, like: torch.Tensor) -> torch.Tensor:
        """Mixed-representation scale tensor of one axis on ``like``'s device."""
        if isinstance(scales_a, tuple):  # (scalar, [vec per axis]) rank-1
            fac, vecs = scales_a
            s = None
            for b, v in enumerate(vecs):
                shape = [1] * self.d
                shape[b] = len(v)
                t = torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(shape)
                s = fac * t if s is None else s * t
            return s
        return torch.as_tensor(scales_a, dtype=like.dtype, device=like.device)

    def apply_scaled(self, xs_and_scales) -> torch.Tensor:
        """y = Σ_f Σ_a fold_a(B_aᵀ(S_a^f ∘ B_a(unfold_a(x_f)))).

        ``xs_and_scales``: list of (x_lattice, scales) where scales is the
        output of ``scales_const`` or ``scales_field``. Plain torch, any d.
        """
        p, N = self.p, self.N
        pairs = [(x.reshape(self.gdims), scales) for x, scales in xs_and_scales]
        D = _diff_tensor(N, pairs[0][0].dtype, pairs[0][0].device)
        y = None
        for a in range(self.d):
            n = self.grid[a]
            acc = None
            for x, scales in pairs:
                win = x.movedim(a, -1).unfold(-1, N, p)  # [.., n, N]
                du = win @ D.T  # du[c, q] = Σ_j D[q, j] x[c·p + j]
                s = self._scale_tensor(scales[a], x).expand(
                    self.gdims[:a] + (n * N,) + self.gdims[a + 1 :]
                )
                s = s.movedim(a, -1).reshape(du.shape)
                acc = s * du if acc is None else torch.addcmul(acc, s, du)
            back = acc @ D  # back[c, k] = Σ_q D[q, k] (S∘du)[c, q]
            ya = back.new_zeros(back.shape[:-2] + (self.gdims[a],))
            ya[..., : n * p] = back[..., :p].flatten(-2)
            ya[..., p::p] += back[..., p]  # node p of cell c is node 0 of c+1
            ya = ya.movedim(-1, a)
            y = ya if y is None else y + ya
        return y
