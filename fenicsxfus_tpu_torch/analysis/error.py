"""Error norms against analytical solutions (numpy, host side).

Copied from ``fenicsxfus_tpu/analysis/error.py``. The numerical solution and
the exact solution are evaluated at a dense Gauss-Legendre quadrature of the
mesh and integrated — an independent (non-GLL) quadrature, which makes it a
genuine oracle for the solver. Fields may be numpy arrays or torch tensors on
any device; they are copied to the host.
"""

from __future__ import annotations

import numpy as np

from ..core.geometry import _geom_grad_tensor, _geom_tab_1d
from ..core.gll import gll_points_weights_01, lagrange_eval_gll
from ..ops.quadrature_ops import _lagrange_derivative, gauss_rule_01


def _host(u) -> np.ndarray:
    if hasattr(u, "detach"):
        u = u.detach().cpu().numpy()
    return np.asarray(u, np.float64).reshape(-1)


def _gauss_quadrature_data(mesh, N: int, nq: int):
    """Dense-quadrature tabulation: returns (tab [nq**d, N**d],
    wdetJ [Nc, nq**d], coords [Nc, nq**d, dim])."""
    d = mesh.dim
    gp, gw = np.polynomial.legendre.leggauss(nq)
    gp = (gp + 1.0) / 2.0
    gw = gw / 2.0
    # Field basis tabulation at the Gauss lattice
    t1 = lagrange_eval_gll(N, gp)  # [nq, N]
    tab = t1
    for _ in range(d - 1):
        tab = np.einsum("qi,rj->qrij", tab, t1).reshape(
            tab.shape[0] * nq, tab.shape[1] * N
        )
    # Geometry at the Gauss lattice
    dshape = _geom_grad_tensor([gp] * d)  # [nq**d, 2**d, d]
    phi1 = _geom_tab_1d(gp)[0]
    shape = phi1
    for _ in range(d - 1):
        shape = np.einsum("qv,rw->qrvw", shape, phi1).reshape(
            shape.shape[0] * nq, shape.shape[1] * 2
        )
    verts = mesh.cell_vertices()
    J = np.einsum("cva,qvb->cqab", verts, dshape)
    detJ = np.abs(np.linalg.det(J))
    w = gw
    for _ in range(d - 1):
        w = np.multiply.outer(w, gw).reshape(-1)
    wdetJ = w[None, :] * detJ
    coords = np.einsum("qv,cvx->cqx", shape, verts)
    return tab, wdetJ, coords


def relative_l2_error(ops, u, exact_fn, nq: int | None = None) -> float:
    """‖u − u_e‖_L2 / ‖u_e‖_L2 with u_e = exact_fn(x), x shape [dim, npts]."""
    mesh = ops.mesh
    N = ops.N
    nq = nq or (N + 4)
    tab, wdetJ, coords = _gauss_quadrature_data(mesh, N, nq)
    uc = _host(u)[np.asarray(ops.space.dofmap)]  # [Nc, N**d]
    uq = uc @ tab.T  # [Nc, nq**d]
    ue = exact_fn(coords.reshape(-1, mesh.dim).T).reshape(uq.shape)
    num = np.sum(wdetJ * (uq - ue) ** 2)
    den = np.sum(wdetJ * ue**2)
    return float(np.sqrt(num) / np.sqrt(den))


def relative_h1_error(ops, u, exact_grad_fn, nq: int | None = None) -> float:
    """H1 seminorm error ‖∇u − ∇u_e‖ / ‖∇u_e‖ at a dense Gauss quadrature
    (the reference's exp2 reports L2 + H1 convergence,
    ``python/experiments/exp2/README.md``). ``exact_grad_fn(x)`` returns the
    exact gradient [dim, npts] at points x [dim, npts]."""
    mesh = ops.mesh
    d, N = mesh.dim, ops.N
    nq = nq or (N + 4)
    gp, gw = gauss_rule_01(nq)
    tabs_v = lagrange_eval_gll(N, gp)  # [nq, N]
    xg, _ = gll_points_weights_01(N)
    tabs_d = _lagrange_derivative(xg, gp)
    # geometry at the Gauss lattice
    dshape = _geom_grad_tensor([gp] * d)
    phi1 = _geom_tab_1d(gp)[0]
    shape = phi1
    for _ in range(d - 1):
        shape = np.einsum("qv,rw->qrvw", shape, phi1).reshape(
            shape.shape[0] * nq, shape.shape[1] * 2
        )
    verts = mesh.cell_vertices()
    J = np.einsum("cva,qvb->cqab", verts, dshape)
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)
    w = gw
    for _ in range(d - 1):
        w = np.multiply.outer(w, gw).reshape(-1)
    wdetJ = w[None, :] * detJ
    coords = np.einsum("qv,cvx->cqx", shape, verts)
    uc = _host(u)[np.asarray(ops.space.dofmap)]  # [Nc, N**d]
    # reference-space gradients at the Gauss lattice
    grads_ref = []
    for a in range(d):
        mats = [tabs_d if ax == a else tabs_v for ax in range(d)]
        B = mats[0]
        for m in mats[1:]:
            B = np.einsum("qn,rm->qrnm", B, m).reshape(
                B.shape[0] * m.shape[0], B.shape[1] * m.shape[1]
            )
        grads_ref.append(uc @ B.T)  # [Nc, nq**d]
    grad_ref = np.stack(grads_ref, axis=-1)  # [Nc, nq**d, d]
    grad_phys = np.einsum("cqb,cqba->cqa", grad_ref, Jinv)
    ge = np.asarray(exact_grad_fn(coords.reshape(-1, d).T)).T.reshape(
        grad_phys.shape
    )
    num = np.sum(wdetJ[..., None] * (grad_phys - ge) ** 2)
    den = np.sum(wdetJ[..., None] * ge**2)
    return float(np.sqrt(num / den))


def l2_norm(ops, u, nq: int | None = None) -> float:
    """‖u‖_L2 at a dense Gauss quadrature."""
    mesh = ops.mesh
    N = ops.N
    nq = nq or (N + 4)
    tab, wdetJ, _ = _gauss_quadrature_data(mesh, N, nq)
    uc = _host(u)[np.asarray(ops.space.dofmap)]
    uq = uc @ tab.T
    return float(np.sqrt(np.sum(wdetJ * uq**2)))
