"""Plain spectral-element operators on a lattice of trilinear hexahedra.

The reference's own discretisation, written from the method and not from
the measured package: Gauss-Lobatto-Legendre (GLL) nodes of degree p in
each cell, collocated quadrature (so every mass-type term is diagonal),
continuous nodal fields numbered on the (n0 p + 1, n1 p + 1, n2 p + 1)
node lattice, axis 0 slowest. Each cell's geometry is its trilinear map
from its eight vertices; nothing assumes the cells are uniform, so the same
code serves the box and the bowl-fitted box.

* ``Discretisation.stiffness``: y = sum_f K_{c_f} x_f with
  (K_c x)_i = int c grad x . grad phi_i, per cell as D^T (G o D z) with the
  1D derivative matrix D and G = w |det J| J^-1 J^-T at each node, summed
  onto the lattice by ``index_add_``.
* ``Discretisation.mass`` and ``facet``: the lumped (diagonal) volume and
  boundary terms.
* ``Discretisation.locate``: the cell and reference coordinates of points
  (Newton on the trilinear map) and their Lagrange weights.

Torch on any device, in float64 (the reference) or in float32 with the
stiffness contractions' operands rounded to TF32 (``tf32=True``: the
control, as a tensor-core product would compute them).
"""

from __future__ import annotations

import numpy as np
import torch

# the symmetric components of G: 00, 01, 02, 11, 12, 22
SYM = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
SYM_INDEX = {**{ab: i for i, ab in enumerate(SYM)}, **{(b, a): i for i, (a, b) in enumerate(SYM)}}


def gll(N: int) -> tuple[np.ndarray, np.ndarray]:
    """The N GLL points on [0, 1] and their weights (summing to 1): the
    end points and the roots of P'_{N-1}, weights 2 / (N (N-1) P_{N-1}^2)
    on [-1, 1], halved."""
    m = N - 1
    Pm = np.polynomial.legendre.Legendre.basis(m)
    x = np.concatenate([[-1.0], np.sort(Pm.deriv().roots().real), [1.0]])
    w = 2.0 / (m * N * Pm(x) ** 2)
    return (x + 1.0) / 2.0, w / 2.0


def lagrange(nodes: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """L[k, i] = l_i(pts[k]) for the Lagrange basis through ``nodes``."""
    pts = np.atleast_1d(np.asarray(pts, np.float64))
    L = np.ones((len(pts), len(nodes)))
    for i, xi in enumerate(nodes):
        for j, xj in enumerate(nodes):
            if i != j:
                L[:, i] *= (pts - xj) / (xi - xj)
    return L


def diff_matrix(nodes: np.ndarray) -> np.ndarray:
    """D[q, i] = l_i'(nodes[q])."""
    N = len(nodes)
    D = np.zeros((N, N))
    for i in range(N):
        for q in range(N):
            s = 0.0
            for k in range(N):
                if k == i:
                    continue
                t = 1.0 / (nodes[i] - nodes[k])
                for j in range(N):
                    if j != i and j != k:
                        t *= (nodes[q] - nodes[j]) / (nodes[i] - nodes[j])
                s += t
            D[q, i] = s
    return D


def q1_shape(xi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Values [n, 8] and gradients [n, 8, 3] of the eight trilinear shape
    functions at reference points ``xi`` [n, 3] (vertex v has the bits
    (v >> 2, v >> 1, v) & 1 as its corner, axis 0 first)."""
    xi = np.atleast_2d(xi)
    val = np.ones((len(xi), 8))
    grad = np.ones((len(xi), 8, 3))
    for v in range(8):
        for a in range(3):
            bit = (v >> (2 - a)) & 1
            f = xi[:, a] if bit else 1.0 - xi[:, a]
            df = 1.0 if bit else -1.0
            val[:, v] *= f
            for b in range(3):
                grad[:, v, b] *= df if a == b else f
    return val, grad


def tensor_points(x1: np.ndarray) -> np.ndarray:
    """The tensor lattice of the 1D points ``x1``, [N**3, 3], axis 0 slowest."""
    return np.stack(np.meshgrid(x1, x1, x1, indexing="ij"), axis=-1).reshape(-1, 3)


def q1_det_at(cell_verts: np.ndarray, N: int) -> np.ndarray:
    """|det J| of the trilinear map of each cell (vertices [nc, 8, 3]) at
    the N**3 GLL lattice; raises on a degenerate or inverted cell."""
    _, grad = q1_shape(tensor_points(gll(N)[0]))
    J = np.einsum("cva,qvb->cqab", cell_verts, grad)
    det = np.linalg.det(J)
    if np.any(det <= 0):
        raise ValueError("degenerate cell")
    return det


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


class Discretisation:
    """The GLL space of degree ``p`` on ``mesh`` (``reference.mesh.Mesh``,
    a lattice of trilinear cells), its geometry on ``device``."""

    CHUNK = 16384  # cells per chunk of the geometry

    def __init__(self, mesh, p: int, device, tf32: bool = False):
        self.mesh, self.p, self.N = mesh, p, p + 1
        self.device = torch.device(device)
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64
        self.n = tuple(mesh.grid_shape)
        self.gdims = tuple(a * p + 1 for a in self.n)
        self.ndofs = int(np.prod(self.gdims))
        self.nc = int(np.prod(self.n))
        N = self.N
        self.x1, self.w1 = gll(N)
        self.D = torch.as_tensor(diff_matrix(self.x1), dtype=self.dtype, device=self.device)
        # the cells' DOFs, [nc, N**3]
        c = np.stack(np.unravel_index(np.arange(self.nc), self.n), axis=1)
        loc = np.stack(np.unravel_index(np.arange(N**3), (N, N, N)), axis=1)
        self.dofmap_np = np.ravel_multi_index(
            [c[:, None, a] * p + loc[None, :, a] for a in range(3)], self.gdims)
        self.cell_verts = mesh.vertices[mesh.cells]  # [nc, 8, 3] host float64
        self._geometry()

    def _geometry(self):
        """wdetJ [nc, N**3] (float64) and G [6, nc, N**3] at the GLL nodes,
        in chunks."""
        N, dev = self.N, self.device
        _, grad = q1_shape(tensor_points(self.x1))
        grad = torch.as_tensor(grad, dtype=torch.float64, device=dev)
        w = torch.as_tensor(np.einsum("i,j,k->ijk", self.w1, self.w1, self.w1).reshape(-1),
                            dtype=torch.float64, device=dev)
        self.wdetJ = torch.empty((self.nc, N**3), dtype=torch.float64, device=dev)
        self.G = torch.empty((6, self.nc, N**3), dtype=self.dtype, device=dev)
        for c0 in range(0, self.nc, self.CHUNK):
            c1 = min(c0 + self.CHUNK, self.nc)
            X = torch.as_tensor(self.cell_verts[c0:c1], dtype=torch.float64, device=dev)
            J = torch.einsum("cva,qvb->cqab", X, grad)
            det = torch.linalg.det(J)
            if bool((det <= 0).any()):
                raise ValueError("the mesh has a degenerate or inverted cell")
            Ji = torch.linalg.inv(J)
            C = Ji @ Ji.transpose(-1, -2)
            wd = w[None, :] * det
            self.wdetJ[c0:c1] = wd
            for k, (a, b) in enumerate(SYM):
                self.G[k, c0:c1] = wd * C[..., a, b]

    # ------------------------------------------------------------ vectors

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.ndofs, dtype=self.dtype, device=self.device)

    def cells_of(self, x: torch.Tensor) -> torch.Tensor:
        """A lattice vector's values in each cell, [nc, N**3] (the cells'
        DOFs in ``dofmap_np`` order): overlapping windows of N nodes at a
        stride of p along each axis."""
        N, p = self.N, self.p
        X = x.view(self.gdims).unfold(0, N, p).unfold(1, N, p).unfold(2, N, p)
        return X.reshape(self.nc, N**3)

    @staticmethod
    def _join(T: torch.Tensor, p: int) -> torch.Tensor:
        """[..., n, p + 1] cell-local values along one axis summed onto its
        n p + 1 lattice nodes (each interface node gets both cells')."""
        n = T.shape[-2]
        out = T.new_zeros(T.shape[:-2] + (n * p + 1,))
        out[..., : n * p].view(T.shape[:-2] + (n, p)).add_(T[..., :p])
        out[..., p::p].add_(T[..., p])
        return out

    def fold(self, cellvals: torch.Tensor) -> torch.Tensor:
        """Sum per-cell nodal values [nc, N**3] onto the lattice, one axis
        at a time."""
        (n0, n1, n2), N, p = self.n, self.N, self.p
        Y = cellvals.reshape(n0, n1, n2, N, N, N)
        Y = self._join(Y.permute(0, 1, 3, 4, 2, 5), p)  # [n0, n1, i, j, g2]
        Y = self._join(Y.permute(0, 2, 4, 1, 3), p)  # [n0, i, g2, g1]
        Y = self._join(Y.permute(2, 3, 0, 1), p)  # [g2, g1, g0]
        return Y.permute(2, 1, 0).reshape(-1)

    def cellwise(self, coeff) -> torch.Tensor:
        """A DG-0 coefficient (scalar or [nc] array) as an [nc] tensor."""
        arr = np.broadcast_to(np.asarray(coeff, np.float64), (self.nc,))
        return torch.as_tensor(np.array(arr), dtype=self.dtype, device=self.device)

    def mass(self, coeff) -> torch.Tensor:
        """The lumped mass of a DG-0 coefficient: sum_c coeff_c w |det J|."""
        c = torch.as_tensor(np.broadcast_to(np.asarray(coeff, np.float64), (self.nc,)).copy(),
                            device=self.device)
        return self.fold(c[:, None] * self.wdetJ).to(self.dtype)

    def _face(self, face: int):
        """(local nodes [N**2], 2D weights [N**2], reference points [N**2, 3])
        of the local face ``face`` = 2 * axis + side."""
        axis, side = divmod(face, 2)
        N = self.N
        ii = np.stack(np.meshgrid(*[np.arange(N)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)
        keep = ii[:, axis] == (0 if side == 0 else N - 1)
        loc = np.flatnonzero(keep)
        tang = [a for a in range(3) if a != axis]
        w2 = self.w1[ii[loc, tang[0]]] * self.w1[ii[loc, tang[1]]]
        return loc, w2, self.x1[ii[loc]], tang

    def facet_terms(self, facets: np.ndarray):
        """For boundary ``facets`` [Nf, 2]: (DOFs [Nf, N**2], w |dS| [Nf, N**2],
        physical coordinates [Nf, N**2, 3], cells [Nf]), host float64."""
        nf = len(facets)
        N2 = self.N**2
        dofs = np.zeros((nf, N2), np.int64)
        wds = np.zeros((nf, N2))
        xyz = np.zeros((nf, N2, 3))
        for face in range(6):
            sel = np.flatnonzero(facets[:, 1] == face)
            if not len(sel):
                continue
            loc, w2, xi, tang = self._face(face)
            val, grad = q1_shape(xi)
            V = self.cell_verts[facets[sel, 0]]
            J = np.einsum("cva,qvb->cqab", V, grad)
            n = np.cross(J[..., :, tang[0]], J[..., :, tang[1]])
            dofs[sel] = self.dofmap_np[facets[sel, 0]][:, loc]
            wds[sel] = w2[None, :] * np.linalg.norm(n, axis=-1)
            xyz[sel] = np.einsum("qv,cva->cqa", val, V)
        return dofs, wds, xyz, facets[:, 0]

    def facet(self, facets: np.ndarray, cell_coeff, nodal=None) -> torch.Tensor:
        """int over ``facets`` of c_cell s(x) phi_i: ``cell_coeff`` a DG-0
        coefficient, ``nodal`` (optional) the profile s at each facet node,
        [Nf, N**2] host float64."""
        dofs, wds, _, cells = self.facet_terms(facets)
        coeff = np.broadcast_to(np.asarray(cell_coeff, np.float64), (self.nc,))
        vals = wds * coeff[cells][:, None]
        if nodal is not None:
            vals = vals * nodal
        out = np.zeros(self.ndofs)
        np.add.at(out, dofs.reshape(-1), vals.reshape(-1))
        return torch.as_tensor(out, dtype=self.dtype, device=self.device)

    # ---------------------------------------------------------- stiffness

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        return to_tf32(x) if self.tf32 else x

    def stiffness(self, xs, coeffs) -> torch.Tensor:
        """sum_f K_{coeffs[f]} xs[f]: ``xs`` lattice vectors [ndofs], each
        coefficient an [nc] tensor (``cellwise``)."""
        N, nc = self.N, self.nc
        z = None
        for x, c in zip(xs, coeffs):
            zc = self.cells_of(x) * c[:, None]
            z = zc if z is None else z + zc
        z = self._round(z).view(nc, N, N, N)
        D = self._round(self.D)
        Dt = D.t().contiguous()
        du = [
            torch.matmul(D, z.reshape(nc, N, N * N)).view(nc, N, N, N),
            torch.matmul(D, z.reshape(nc * N, N, N)).view(nc, N, N, N),
            torch.matmul(z.reshape(-1, N), Dt).view(nc, N, N, N),
        ]
        G = self.G.view(6, nc, N, N, N)
        y = None
        for a in range(3):
            g = G[SYM_INDEX[(a, 0)]] * du[0] + G[SYM_INDEX[(a, 1)]] * du[1] \
                + G[SYM_INDEX[(a, 2)]] * du[2]
            g = self._round(g)
            if a == 0:
                ya = torch.matmul(Dt, g.reshape(nc, N, N * N)).view(nc, N, N, N)
            elif a == 1:
                ya = torch.matmul(Dt, g.reshape(nc * N, N, N)).view(nc, N, N, N)
            else:
                ya = torch.matmul(g.reshape(-1, N), D).view(nc, N, N, N)
            y = ya if y is None else y + ya
        return self.fold(y.reshape(nc, N**3))

    # ------------------------------------------------------------ points

    def locate(self, points: np.ndarray):
        """(DOFs [n, N**3], Lagrange weights [n, N**3]) of ``points`` [3, n]:
        each point's cell (the first whose trilinear map reaches it, by
        Newton from the cell's centre) and its reference coordinates."""
        pts = np.asarray(points, np.float64).T
        V = self.cell_verts
        lo, hi = V.min(axis=1), V.max(axis=1)
        tol = 1e-9 * float(np.max(hi - lo))
        rows = np.zeros((len(pts), self.N**3), np.int64)
        wts = np.zeros((len(pts), self.N**3))
        for k, x in enumerate(pts):
            cand = np.flatnonzero(np.all((x >= lo - tol) & (x <= hi + tol), axis=1))
            for c in cand:
                xi = np.full(3, 0.5)
                for _ in range(40):
                    val, grad = q1_shape(xi[None])
                    r = val[0] @ V[c] - x
                    J = V[c].T @ grad[0]
                    step = np.linalg.solve(J, r)
                    xi = xi - step
                    if np.max(np.abs(step)) < 1e-14:
                        break
                if np.all(xi >= -1e-10) and np.all(xi <= 1 + 1e-10):
                    xi = np.clip(xi, 0.0, 1.0)
                    L = [lagrange(self.x1, xi[a])[0] for a in range(3)]
                    wts[k] = np.einsum("i,j,k->ijk", *L).reshape(-1)
                    rows[k] = self.dofmap_np[c]
                    break
            else:
                raise ValueError(f"sensor {x} lies outside the mesh")
        return rows, wts
