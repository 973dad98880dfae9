"""Spectral-element operators on a uniform 3D lattice.

Port of the uniform-lattice subset of
``fenicsxfus_tpu/ops/operators.py::SEMOperators``: with collocated GLL
quadrature every mass-type term is diagonal, so the lumped mass and the
boundary source/ABC vectors are assembled once on the host (numpy) and
applied as elementwise products; the stiffness runs the packed K1 form
(``ops/stiffness.py``). Non-uniform, non-axis-aligned and non-3D meshes raise
``NotImplementedError``: they arrive with later slices of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.geometry import facet_factors, is_uniform_mesh, volume_factors
from ..core.mesh import Mesh
from ..core.space import build_space
from ..utils import resolve_device
from .lattice import LatticeStiffness, numpy_dtype
from .stiffness import pack_const, pack_field, stiffness_apply


class SEMOperators:
    """Operator data for one function space on a uniform 3D lattice.

    Parameters
    ----------
    mesh : core.mesh.Mesh from ``create_box``
    degree : polynomial degree p (GLL basis has N = p+1 nodes per axis)
    dtype : torch dtype of the device fields
    device : torch device of the fields (default the card; the CPU only
        when asked for)
    """

    def __init__(self, mesh, degree: int, dtype=torch.float32, device="cuda"):
        if mesh.dim != 3 or mesh.grid_shape is None:
            raise NotImplementedError("only structured 3D meshes (create_box) are ported")
        self.mesh = mesh
        self.degree = degree
        self.dtype = dtype
        self.device = resolve_device(device)
        self.space = build_space(mesh, degree)
        d, N = mesh.dim, self.space.N
        self.d, self.N = d, N
        self.ndofs = self.space.ndofs
        self.num_cells = mesh.num_cells
        if not is_uniform_mesh(mesh):
            raise NotImplementedError("only uniform lattices are ported")
        # geometry of one cell: every cell of a uniform mesh is a translate
        sub = Mesh(
            dim=d,
            vertices=mesh.vertices[mesh.cells[0]],
            cells=np.arange(2**d, dtype=np.int64)[None, :],
        )
        _, G = volume_factors(sub, N)
        off = np.delete(G[0], [0, 3, 5], axis=-1)
        if np.max(np.abs(off)) >= 1e-12 * np.max(np.abs(G[0])):
            raise NotImplementedError("only axis-aligned lattices are ported")
        lo = mesh.vertices.min(axis=0)
        hi = mesh.vertices.max(axis=0)
        h = [(hi[a] - lo[a]) / mesh.grid_shape[a] for a in range(d)]
        self.lattice = LatticeStiffness(mesh.grid_shape, degree, h, dtype)
        self.gdims = self.lattice.gdims
        self._facet_cache: dict[int, tuple] = {}

    def to_device(self, arr) -> torch.Tensor:
        """A host array as a tensor of the operator dtype on its device."""
        return torch.as_tensor(np.asarray(arr), dtype=self.dtype, device=self.device)

    # -------------------------------------------------------- diagonal (mass)

    def assemble_diag(self, cell_coeff) -> np.ndarray:
        """Assembled diagonal of the coefficient-weighted mass matrix on the
        host: m[i] = Σ_{cells c ∋ i} coeff_c · w_i · |detJ|_c(i)
        (reference lumped mass, ``_linear.py:348-353``). Flat [ndofs], in the
        host counterpart of the device dtype."""
        m = self.lattice.mass_diag(np.asarray(cell_coeff))
        return np.asarray(m, numpy_dtype(self.dtype)).reshape(-1)

    # --------------------------------------------------------------- stiffness

    def stiff_coeff(self, coeff) -> dict:
        """Packed F tensors of a DG-0 stiffness coefficient (scalar or [Nc])
        on the device: rank-1 planes if it is constant, cell-resolved
        otherwise."""
        arr = np.asarray(coeff, np.float64)
        if arr.ndim == 0:
            return pack_const(self.lattice, float(arr), self.device)
        if arr.size == self.num_cells and np.ptp(arr) == 0:
            return pack_const(self.lattice, float(arr.reshape(-1)[0]), self.device)
        return pack_field(self.lattice, arr, self.device)

    def stiffness_apply(self, xs, coeffs) -> torch.Tensor:
        """y = Σ_f K_{coeff_f}(x_f)  where K_c(u)·φ_i = ∫ c ∇u·∇φ_i dx.

        ``xs``: global vectors [ndofs] (or lattice-shaped); ``coeffs``: packed
        coefficients from ``stiff_coeff``. Returns a flat [ndofs] vector."""
        y = stiffness_apply([x.reshape(self.gdims) for x in xs], coeffs, self.degree)
        return y.reshape(-1)

    # ------------------------------------------------------------------ facets

    def facet_data(self, tag: int):
        if tag not in self._facet_cache:
            facets = self.mesh.facet_tags.get(tag, np.zeros((0, 2), np.int64))
            gdofs, wdetJf, cells = facet_factors(self.mesh, self.space, facets)
            self._facet_cache[tag] = (gdofs.reshape(-1), wdetJf.reshape(-1), cells)
        return self._facet_cache[tag]

    def facet_vector(self, tag: int, cell_coeff) -> np.ndarray:
        """Assembled vector of ∫_{Γ_tag} coeff φ_i ds on the host (GLL
        collocated, so boundary mass terms are diagonal too): the transducer
        source vector (tag 1) and the Sommerfeld ABC diagonal (tag 2);
        reference forms ``_linear.py:355-361``. Flat [ndofs], in the host
        counterpart of the device dtype."""
        gdofs, w, cells = self.facet_data(tag)
        npdt = numpy_dtype(self.dtype)
        coeff = np.broadcast_to(
            np.asarray(cell_coeff, npdt).reshape(-1), (self.num_cells,)
        )
        vals = np.asarray(w, npdt) * (
            np.repeat(coeff[cells], w.shape[0] // max(len(cells), 1))
            if len(cells)
            else np.zeros(0, npdt)
        )
        out = np.zeros(self.ndofs, npdt)
        np.add.at(out, np.asarray(gdofs), vals)
        return out

    def facet_vector_nodal(self, tag: int, nodal_coeff, cell_coeff=None) -> np.ndarray:
        """Assembled ∫_{Γ_tag} c_cell · s(x) φ_i ds on the host, with a
        per-DOF profile ``s`` [ndofs] and an optional DG-0 material
        coefficient ``cell_coeff``: the phase-split sources of the focused
        model in heterogeneous media (the reference keeps per-cell 1/ρ inside
        its facet forms, ``_lossy.py:107-128``). Flat [ndofs], in the host
        counterpart of the device dtype."""
        gdofs, w, cells = self.facet_data(tag)
        npdt = numpy_dtype(self.dtype)
        gd = np.asarray(gdofs)
        vals = np.asarray(w, npdt) * np.asarray(nodal_coeff, npdt)[gd]
        if cell_coeff is not None:
            coeff = np.broadcast_to(
                np.asarray(cell_coeff, npdt).reshape(-1), (self.num_cells,)
            )
            if len(cells):
                vals = vals * np.repeat(coeff[cells], w.shape[0] // len(cells))
        out = np.zeros(self.ndofs, npdt)
        np.add.at(out, gd, vals)
        return out

    # ------------------------------------------------------------ interpolation

    def dof_coords(self) -> np.ndarray:
        """Physical coordinates of the DOFs, [ndofs, dim] (host float64)."""
        return self.space.dof_coords

    def interpolate(self, fn) -> torch.Tensor:
        """Nodal interpolation of ``fn(x)`` (x: [dim, ndofs]) onto the space."""
        return self.to_device(fn(self.space.dof_coords.T))
