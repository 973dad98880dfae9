"""Non-collocated (Gauss-quadrature) matrix-free operators.

Port of ``fenicsxfus_tpu/ops/quadrature_ops.py``: the analogue of the
reference's dense-tabulation variant (``cpp/fenicsx-pc/common/
precompute_op.hpp``: ``Mass2D/3D`` :38-138, ``Stiffness2D/3D`` :294-486),
which decouples the quadrature rule from the basis degree, and of the
Python package's Gauss-quadrature ``LinearExplicit`` solver
(``_linear.py:12-255``), whose mass matrix is *not* diagonal.

Sum-factorised over the cell axis: gather the cell values
(``SEMOperators.gather_combine``), evaluate them at the Gauss lattice with
the tabulation T [nq, N] (dT for a derivative) one axis at a time, scale by
the geometry factors at the Gauss points
(``core/geometry.py::quadrature_factors``), contract back with Tᵀ, and fold
onto the DOFs (``SEMOperators.scatter``, the deterministic fold). On a
lattice the gather and the fold use the lattice numbering of
``core/space.py``, as the JAX package's ``space.dofmap`` does. No TPU kernel
is on this path (the JAX package runs it in XLA), so it is plain torch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.geometry import SYM_PAIRS, quadrature_factors
from ..core.gll import gll_points_weights_01, lagrange_eval_gll

# forward contraction along each axis of a d-dimensional cell block (d = 1, 2, 3)
_FWD = {
    1: ("qi,ci->cq",),
    2: ("qi,cij->cqj", "rj,cqj->cqr"),
    3: ("qi,cijk->cqjk", "rj,cqjk->cqrk", "sk,cqrk->cqrs"),
}
# its transpose, last axis first
_BWD = {
    1: ("qi,cq->ci",),
    2: ("rj,cqr->cqj", "qi,cqj->cij"),
    3: ("sk,cqrs->cqrk", "rj,cqrk->cqjk", "qi,cqjk->cijk"),
}


def gauss_rule_01(nq: int):
    """The ``nq``-point Gauss-Legendre rule on [0, 1]: (points, weights)."""
    gp, gw = np.polynomial.legendre.leggauss(nq)
    return (gp + 1.0) / 2.0, gw / 2.0


class QuadratureOperators:
    """Mass / stiffness actions with an ``nq``-point Gauss rule per axis
    (default N + 1), sharing the function space (and its gather and fold)
    of an existing ``SEMOperators``. The geometry factors live on the
    operators' device: ``wdetJ`` [Nc, nq, ..., nq] and ``G`` component-major
    [nsym, Nc, nq, ..., nq]."""

    def __init__(self, ops, nq: int | None = None):
        self.ops = ops
        self.d = ops.d
        self.N = ops.N
        self.nq = nq or ops.N + 1
        x1, w1 = gauss_rule_01(self.nq)
        # basis value + derivative tabulation at the quadrature points
        xg, _ = gll_points_weights_01(self.N)
        T = lagrange_eval_gll(self.N, x1)  # [nq, N]
        dT = _lagrange_derivative(xg, x1)  # [nq, N]
        self._T_np = T
        self.T = ops.to_device(T)
        self.dT = ops.to_device(dT)
        wdetJ, G = quadrature_factors(ops.mesh, x1, w1)
        self._wdetJ_np = wdetJ
        shape = (-1,) + (self.nq,) * self.d
        self.wdetJ = ops.to_device(wdetJ.reshape(shape))
        self.G = torch.empty((G.shape[-1],) + self.wdetJ.shape, dtype=ops.dtype,
                             device=ops.device)
        for k in range(G.shape[-1]):  # one component at a time: no [Nc, Nq, nsym] copy
            self.G[k].copy_(torch.from_numpy(np.ascontiguousarray(G[:, :, k])).view(
                self.G[k].shape))

    # ----------------------------------------------------------- evaluation
    def _fwd(self, z, mats):
        """Evaluate cell values at the quadrature lattice with per-axis
        matrices ``mats[a]`` [nq, N]."""
        for eq, m in zip(_FWD[self.d], mats):
            z = torch.einsum(eq, m, z)
        return z

    def _bwd(self, f, mats):
        """Transpose of ``_fwd``: quadrature lattice → cell values."""
        for eq, m in zip(_BWD[self.d], mats[::-1]):
            f = torch.einsum(eq, m, f)
        return f

    # ------------------------------------------------------------ operators
    def mass_apply(self, x, coeff) -> torch.Tensor:
        """Consistent (non-lumped) mass action M x with a DG-0 coefficient
        (scalar, [Nc] array or tensor). Flat [ndofs]."""
        ops = self.ops
        mats = [self.T] * self.d
        f = self._fwd(ops.gather_combine([x], [coeff]), mats) * self.wdetJ
        return ops.scatter(self._bwd(f, mats))

    def mass_diag(self, coeff) -> torch.Tensor:
        """Diagonal of the consistent mass (the Jacobi preconditioner),
        per cell on the host in float64, folded on the device."""
        d, N, nq = self.d, self.N, self.nq
        T2 = self._T_np**2  # [nq, N]
        Phi2 = T2
        for _ in range(d - 1):
            Phi2 = np.einsum("qi,rj->qrij", Phi2, T2).reshape(Phi2.shape[0] * nq,
                                                              Phi2.shape[1] * N)
        coeff_arr = np.broadcast_to(np.asarray(coeff, np.float64).reshape(-1),
                                    (self.ops.num_cells,))
        diag_cells = coeff_arr[:, None] * (self._wdetJ_np @ Phi2)
        return self.ops.scatter(self.ops.to_device(diag_cells.reshape((-1,) + (N,) * d)))

    def stiffness_apply(self, xs, coeffs) -> torch.Tensor:
        """Σ_f K_{coeff_f}(x_f) with the Gauss rule (exact for affine cells,
        reference ``precompute_op.hpp`` Stiffness kernels). Flat [ndofs]."""
        ops, d = self.ops, self.d
        z = ops.gather_combine(xs, coeffs)
        mats_by_axis = [[self.dT if b == a else self.T for b in range(d)] for a in range(d)]
        grads = [self._fwd(z, mats_by_axis[a]) for a in range(d)]
        sym = {pair: i for i, pair in enumerate(SYM_PAIRS[d])}
        y = None
        for a in range(d):
            acc = self.G[sym[(0, a)]] * grads[0]
            for b in range(1, d):
                acc = torch.addcmul(acc, self.G[sym[(min(a, b), max(a, b))]], grads[b])
            ya = self._bwd(acc, mats_by_axis[a])
            y = ya if y is None else y + ya
        return ops.scatter(y)


def _lagrange_derivative(nodes: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """dl_i/dx at arbitrary points (barycentric differentiation)."""
    n = len(nodes)
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    bw = 1.0 / np.prod(diff, axis=1)
    out = np.zeros((len(pts), n))
    for p, xp in enumerate(pts):
        d = xp - nodes
        onnode = np.isclose(d, 0.0, atol=1e-14)
        if onnode.any():
            q = int(np.argmax(onnode))
            for i in range(n):
                if i != q:
                    out[p, i] = bw[i] / bw[q] / (nodes[q] - nodes[i])
            out[p, q] = -np.sum(out[p])
        else:
            lx = np.prod(d)  # ∏(x−x_j)
            for i in range(n):
                s = np.sum(1.0 / d) - 1.0 / d[i]
                out[p, i] = bw[i] * lx / d[i] * s
    return out
