"""Spectral-element function space: dofmaps and assembly index maps.

Copied from ``fenicsxfus_tpu/core/space.py`` (numpy, no jax), structured
meshes only. Element DOFs are generated directly in tensor-lexicographic
(i0 slowest) order, so no permutation is ever needed (reference
``cpp/fenicsx-sf/common/permute.hpp:15-42``). The space provides, lazily:

* ``dofmap`` [Nc, N**d] int32 — global DOF index of each cell-local GLL node,
* ``dof_coords`` [ndofs, dim] — for interpolation of analytical fields.

Everything heavy is a ``cached_property``: the lattice path (ops/lattice.py)
needs none of it. ``dofmap_for_cells`` serves facet assembly with only the
boundary cells' maps. Unstructured meshes (entity-blocked numbering) arrive
with a later slice of the port.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

from .gll import gll_points_weights_01


def _geom_basis_1d(pts: np.ndarray) -> np.ndarray:
    """Linear geometry basis {1-x, x} tabulated at ``pts``: [npts, 2]."""
    return np.stack([1.0 - pts, pts], axis=-1)


def cell_node_coords(mesh, N: int, cells=None) -> np.ndarray:
    """Physical coordinates of the GLL node lattice of cells (default: all).

    Returns [Nc, N**d, dim]; local nodes in tensor-lex order (axis 0 slowest).
    """
    d = mesh.dim
    x1, _ = gll_points_weights_01(N)
    phi = _geom_basis_1d(x1)  # [N, 2]
    shape = phi
    for _ in range(d - 1):
        shape = np.einsum("ia,jb->ijab", shape.reshape(shape.shape[0], -1), phi).reshape(
            shape.shape[0] * N, -1
        )
    # shape: [N**d, 2**d] with both indices tensor-lex (axis 0 slowest)
    conn = mesh.cells if cells is None else mesh.cells[cells]
    verts = mesh.vertices[conn]  # [nc, 2**d, dim]
    return np.einsum("nv,cvx->cnx", shape, verts)


class FunctionSpace:
    def __init__(self, mesh, degree: int):
        self.mesh = mesh
        self.degree = degree
        if mesh.grid_shape is None:
            raise NotImplementedError(
                "unstructured meshes are not ported yet; use create_interval, "
                "create_rectangle or create_box"
            )
        self._gdims = tuple(na * degree + 1 for na in mesh.grid_shape)
        self.ndofs = int(np.prod(self._gdims))

    @property
    def N(self) -> int:
        return self.degree + 1

    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def nodes_per_cell(self) -> int:
        return self.N ** self.mesh.dim

    # ------------------------------------------------------------- helpers
    def _node_lattice_indices(self):
        """Per-axis (cell index, local node) → global lattice index arrays."""
        d = self.dim
        N, p = self.N, self.degree
        node_axes = [np.arange(N)] * d
        ngrids = np.meshgrid(*node_axes, indexing="ij")
        return [g.reshape(-1) for g in ngrids]  # [N**d] per axis

    def dofmap_for_cells(self, cells: np.ndarray) -> np.ndarray:
        """Global DOF indices for a subset of cells: [len(cells), N**d]."""
        d, p = self.dim, self.degree
        n = self.mesh.grid_shape
        cidx = np.unravel_index(np.asarray(cells, np.int64), n)
        i = self._node_lattice_indices()
        idx = [cidx[a][:, None] * p + i[a][None, :] for a in range(d)]
        return np.ravel_multi_index(idx, self._gdims).astype(np.int32)

    # ------------------------------------------------------- lazy big data
    @cached_property
    def dofmap(self) -> np.ndarray:
        return self.dofmap_for_cells(np.arange(self.mesh.num_cells))

    @cached_property
    def dof_coords(self) -> np.ndarray:
        coords = cell_node_coords(self.mesh, self.N).reshape(-1, self.mesh.dim)
        out = np.zeros((self.ndofs, self.mesh.dim))
        out[self.dofmap.reshape(-1)] = coords
        return out

    def face_local_dofs(self, axis: int, side: int) -> np.ndarray:
        """Cell-local indices of the GLL sub-lattice on face {xi_axis == side}.

        Returned in tensor-lex order over the remaining axes: [N**(d-1)].
        """
        d, N = self.mesh.dim, self.N
        lattice = np.arange(N**d).reshape((N,) * d)
        sl = [slice(None)] * d
        sl[axis] = 0 if side == 0 else N - 1
        return lattice[tuple(sl)].reshape(-1)


def build_space(mesh, degree: int) -> FunctionSpace:
    return FunctionSpace(mesh, degree)
