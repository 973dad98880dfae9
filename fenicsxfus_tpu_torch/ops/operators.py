"""Spectral-element operators on a uniform lattice (1D, 2D or 3D) or a
bowl-fitted 3D lattice.

Port of the lattice subset of ``fenicsxfus_tpu/ops/operators.py::
SEMOperators``: with collocated GLL quadrature every mass-type term is
diagonal, so the lumped mass and the boundary source/ABC vectors are
assembled once on the host (numpy) and applied as elementwise products; the
stiffness runs the packed K1 form (``ops/stiffness.py``) on a 3D lattice.
On a 1D or 2D lattice, where the JAX package has no Pallas kernel and runs
``LatticeStiffness.apply_scaled``, the port runs its own d-generic
``apply_scaled`` (plain torch ops on the fields' device) over the lattice
scales of ``stiff_coeff``. ``stiffness_diag`` (the Jacobi preconditioner of
the implicit models) is an index-free host fold.

A bowl-fitted lattice (``core/bowl.py::create_bowl_box``: only its first
``blend_layers`` x-layers of cells are deformed, the rest is the uniform
box ``uniform_box``) takes the hybrid path of the JAX package: the stiffness
splits as K = K_uniform(whole lattice) + K_{c·(G_cell − G_uniform)}(slab),
the first term K1 on the uniform box's lattice and the second the slab
correction K6 (``ops/band.py``); the lumped mass and the stiffness diagonal
gain the slab's per-cell corrections the same way. ``FUS_HYBRID=0`` (the
JAX package's general per-cell path) is not ported and raises on a
deformed mesh, as do other non-uniform, non-axis-aligned and unstructured
meshes.
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from ..core.geometry import SYM_PAIRS, facet_factors, is_uniform_mesh, volume_factors
from ..core.gll import diff_matrix
from ..core.mesh import Mesh
from ..core.space import build_space
from ..utils import resolve_device
from .band import band_correction_rows
from .lattice import LatticeStiffness, numpy_dtype
from .stiffness import pack_const, pack_field, stiffness_apply, stiffness_plain


def _one_cell(lo, h) -> Mesh:
    """A mesh of the single axis-aligned cell [lo, lo + h]."""
    d = len(h)
    verts = np.stack(np.meshgrid(*[[0.0, h[a]] for a in range(d)], indexing="ij"),
                     axis=-1).reshape(-1, d)
    return Mesh(dim=d, vertices=np.asarray(lo, np.float64)[None, :] + verts,
                cells=np.arange(2**d, dtype=np.int64)[None, :])


class SEMOperators:
    """Operator data for one function space on a uniform lattice (d = 1, 2
    or 3) or a bowl-fitted 3D lattice.

    Parameters
    ----------
    mesh : core.mesh.Mesh from ``create_interval``, ``create_rectangle``,
        ``create_box`` or ``create_bowl_box``
    degree : polynomial degree p (GLL basis has N = p+1 nodes per axis)
    dtype : torch dtype of the device fields
    device : torch device of the fields (default the card; the CPU only
        when asked for)

    ``hybrid`` is None on a uniform lattice; on a bowl-fitted one it holds
    the slab: ``bx`` cell layers, ``nb`` cells, their ``blocks`` per axis,
    ``slab_x`` lattice rows, the correction factors ``G_corr`` [6, nb, N,
    N, N] on the device and, on the host, the same factors ``G_corr_np``
    in float64 and the mass correction ``wdetJ_corr_np`` [nb, N**3].
    ``setup_seconds`` holds the host time of the hybrid setup's parts.

    ``stiffness_fn`` is the 3D stiffness function ``(xs, Fs, p) -> y``:
    ``ops.stiffness.stiffness_apply``, the K1 wrapper, unless ``plain()``
    made this copy, whose 3D stiffness is ``stiffness_plain`` on any device.
    """

    stiffness_fn = staticmethod(stiffness_apply)

    def __init__(self, mesh, degree: int, dtype=torch.float32, device="cuda"):
        if mesh.grid_shape is None:
            raise NotImplementedError(
                "only structured meshes (create_interval, create_rectangle, create_box, "
                "create_bowl_box) are ported")
        self.mesh = mesh
        self.degree = degree
        self.dtype = dtype
        self.device = resolve_device(device)
        self.space = build_space(mesh, degree)
        d, N = mesh.dim, self.space.N
        self.d, self.N = d, N
        self.ndofs = self.space.ndofs
        self.num_cells = mesh.num_cells
        self.hybrid = None
        self.setup_seconds = {}
        if is_uniform_mesh(mesh):
            self._setup_uniform()
        elif mesh.blend_layers and mesh.uniform_box is not None:
            # the branch condition of the JAX package's operators.py:78-97
            if os.environ.get("FUS_HYBRID", "") == "0":
                raise NotImplementedError(
                    "FUS_HYBRID=0: the general per-cell operator path is not ported")
            self._setup_hybrid(int(mesh.blend_layers))
        else:
            raise NotImplementedError(
                "only uniform lattices and bowl-fitted (hybrid) lattices are ported")
        self.gdims = self.lattice.gdims
        self._facet_cache: dict[int, tuple] = {}

    def _setup_uniform(self):
        """The lattice operator of a uniform axis-aligned mesh."""
        mesh, d = self.mesh, self.d
        # geometry of one cell: every cell of a uniform mesh is a translate
        sub = Mesh(
            dim=d,
            vertices=mesh.vertices[mesh.cells[0]],
            cells=np.arange(2**d, dtype=np.int64)[None, :],
        )
        _, G = volume_factors(sub, self.N)
        diag = [i for i, (a, b) in enumerate(SYM_PAIRS[d]) if a == b]
        off = np.delete(G[0], diag, axis=-1)
        if off.size and np.max(np.abs(off)) >= 1e-12 * np.max(np.abs(G[0])):
            raise NotImplementedError("only axis-aligned lattices are ported")
        lo = mesh.vertices.min(axis=0)
        hi = mesh.vertices.max(axis=0)
        h = [(hi[a] - lo[a]) / mesh.grid_shape[a] for a in range(d)]
        self.lattice = LatticeStiffness(mesh.grid_shape, self.degree, h, self.dtype)

    def _setup_hybrid(self, blend_layers: int):
        """The hybrid split (JAX package ``_setup_hybrid``): the lattice
        operator of the uniform box for the whole grid, and the correction
        factors of the slab, its first ``blend_layers`` x-layers of cells
        (the first nb cells): each slab cell's factors minus one uniform
        cell's."""
        mesh, d, N, p = self.mesh, self.d, self.N, self.degree
        gs = mesh.grid_shape
        lo_u, hi_u = (np.asarray(b, np.float64) for b in mesh.uniform_box)
        h = [(hi_u[a] - lo_u[a]) / gs[a] for a in range(d)]
        self.lattice = LatticeStiffness(gs, p, h, self.dtype)
        bx = min(blend_layers, gs[0])
        blocks = (bx,) + tuple(gs[1:])
        nb = int(np.prod(blocks))  # slab cells are the first nb cells
        t0 = time.perf_counter()
        sub = Mesh(dim=d, vertices=mesh.vertices, cells=mesh.cells[:nb])
        wdetJ_b, G_b = volume_factors(sub, N)  # [nb, N**3], [nb, N**3, 6]
        wdetJ_u, G_u = volume_factors(_one_cell(lo_u, h), N)  # [1, ...]
        self.setup_seconds["volume_factors"] = time.perf_counter() - t0
        G_corr = np.moveaxis(G_b - G_u, -1, 0).reshape((6, nb) + (N,) * d)
        t0 = time.perf_counter()
        self.hybrid = {
            "bx": bx,
            "nb": nb,
            "blocks": blocks,
            "slab_x": bx * p + 1,
            "G_corr": self.to_device(G_corr),
            "G_corr_np": G_corr,
            "wdetJ_corr_np": wdetJ_b - wdetJ_u,
        }
        self.D = self.to_device(diff_matrix(N))
        self.setup_seconds["upload"] = time.perf_counter() - t0

    def to_device(self, arr) -> torch.Tensor:
        """A host array as a tensor of the operator dtype on its device."""
        return torch.as_tensor(np.asarray(arr), dtype=self.dtype, device=self.device)

    # -------------------------------------------------------- diagonal (mass)

    def assemble_diag(self, cell_coeff) -> np.ndarray:
        """Assembled diagonal of the coefficient-weighted mass matrix on the
        host: m[i] = Σ_{cells c ∋ i} coeff_c · w_i · |detJ|_c(i)
        (reference lumped mass, ``_linear.py:348-353``); on a hybrid lattice
        the uniform box's fold plus the slab's per-cell correction. Flat
        [ndofs], in the host counterpart of the device dtype."""
        m = self.lattice.mass_diag(np.asarray(cell_coeff)).reshape(-1)
        if self.hybrid is not None:
            m = m + self._diag_band_np(cell_coeff, self.hybrid["wdetJ_corr_np"])
        return np.asarray(m, numpy_dtype(self.dtype))

    def _diag_band_np(self, cell_coeff, percell_np) -> np.ndarray:
        """Host scatter-add of a per-slab-cell diagonal correction
        ``percell_np`` [nb, N**3] weighted by the slab cells' coefficients
        (float64, [ndofs])."""
        nb = self.hybrid["nb"]
        coeff = np.broadcast_to(
            np.asarray(cell_coeff, np.float64).reshape(-1), (self.num_cells,)
        )[:nb]
        dof_b = np.asarray(self.space.dofmap_for_cells(np.arange(nb)))
        out = np.zeros(self.ndofs)
        np.add.at(out, dof_b.reshape(-1), (coeff[:, None] * percell_np.reshape(nb, -1)).reshape(-1))
        return out

    # --------------------------------------------------------------- stiffness

    def _pack(self, coeff) -> dict:
        """Packed F tensors of a DG-0 coefficient on the (uniform box's)
        lattice: rank-1 planes if it is constant, cell-resolved otherwise."""
        arr = np.asarray(coeff, np.float64)
        if arr.ndim == 0:
            return pack_const(self.lattice, float(arr), self.device)
        if arr.size == self.num_cells and np.ptp(arr) == 0:
            return pack_const(self.lattice, float(arr.reshape(-1)[0]), self.device)
        return pack_field(self.lattice, arr, self.device)

    def pack_scales(self, coeff):
        """The lattice scales of a DG-0 coefficient on the device (the JAX
        package's ``pack_scales``): a constant one as a list, per axis, of
        (scalar, [one vector per axis]); a cell-resolved one as a tuple of
        the per-axis scale tensors of ``LatticeStiffness.scales_field``."""
        arr = np.asarray(coeff, np.float64)
        if arr.ndim == 0 or (arr.size == self.num_cells and np.ptp(arr) == 0):
            return [(fac, [self.to_device(v) for v in vecs])
                    for fac, vecs in self.lattice.scales_const(float(arr.reshape(-1)[0]))]
        return tuple(self.to_device(t) for t in self.lattice.scales_field(arr))

    def stiff_coeff(self, coeff):
        """A DG-0 stiffness coefficient (scalar or [Nc]) prepared on the
        device: the packed F tensors on a uniform 3D lattice, the lattice
        scales (``pack_scales``) on a 1D or 2D one; on a hybrid lattice
        {"hyb_u": the packed F tensors of the uniform part, "hyb_b": the
        slab cells' coefficients [nb], "hyb_G": the slab's correction
        factors, shared by every coefficient}."""
        if self.d != 3:
            return self.pack_scales(coeff)
        if self.hybrid is None:
            return self._pack(coeff)
        if isinstance(coeff, dict) and "hyb_u" in coeff:
            return coeff
        full = np.broadcast_to(np.asarray(coeff, np.float64).reshape(-1), (self.num_cells,))
        return {
            "hyb_u": self._pack(full),
            "hyb_b": self.to_device(np.array(full[: self.hybrid["nb"]])),
            "hyb_G": self.hybrid["G_corr"],
        }

    def band_correction_rows(self, rows, band_coeffs, G) -> torch.Tensor:
        """The slab correction K6 (``ops/band.py``) of the fields' slab rows
        ``rows`` [slab_x, G1, G2] with the slab coefficients ``band_coeffs``
        and factors ``G``; returns the correction on the same rows."""
        hy = self.hybrid
        return band_correction_rows(rows, band_coeffs, G, self.D, hy["blocks"], self.degree)

    def stiffness_apply(self, xs, coeffs) -> torch.Tensor:
        """y = Σ_f K_{coeff_f}(x_f)  where K_c(u)·φ_i = ∫ c ∇u·∇φ_i dx.

        ``xs``: global vectors [ndofs] (or lattice-shaped); ``coeffs``:
        coefficients from ``stiff_coeff`` (on a hybrid lattice raw DG-0
        coefficients are prepared here). Returns a flat [ndofs] vector. On a
        3D lattice ``stiffness_fn``: K1 (or K4a then K4b under
        ``FUS_V3=0``); on a 1D or 2D lattice ``LatticeStiffness.
        apply_scaled``. On a hybrid lattice: the same of the uniform parts,
        plus the slab correction K6 added onto the slab rows."""
        x3 = [x.reshape(self.gdims) for x in xs]
        if self.d != 3:
            return self.lattice.apply_scaled(list(zip(x3, coeffs))).reshape(-1)
        if self.hybrid is None:
            return self.stiffness_fn(x3, coeffs, self.degree).reshape(-1)
        cs = [self.stiff_coeff(c) for c in coeffs]
        y = self.stiffness_fn(x3, [c["hyb_u"] for c in cs], self.degree)
        sx = self.hybrid["slab_x"]
        y[:sx] += self.band_correction_rows(
            [x[:sx] for x in x3], [c["hyb_b"] for c in cs], cs[0]["hyb_G"])
        return y.reshape(-1)

    def plain(self) -> "SEMOperators":
        """A shallow copy of these operators whose 3D stiffness runs
        ``stiffness_plain`` (no kernel) on any device; everything else is
        shared."""
        ops = copy.copy(self)
        ops.stiffness_fn = stiffness_plain
        return ops

    def stiffness_diag(self, cell_coeff) -> torch.Tensor:
        """Assembled diagonal of the stiffness matrix of a DG-0 coefficient
        (the Jacobi preconditioner of the implicit models; the reference
        uses PETSc PC Jacobi, ``_linear.py:644-647``): the index-free host
        fold ``LatticeStiffness.stiffness_diag``, on a hybrid lattice plus
        the slab cells' corrections. Flat [ndofs] on the device."""
        kd = self.lattice.stiffness_diag(np.asarray(cell_coeff))
        if self.hybrid is not None:
            # the slab cells' stiffness-diagonal corrections [nb, N**3]
            nb = self.hybrid["nb"]
            diag_b = _stiffness_diag_cells_np(
                np.moveaxis(self.hybrid["G_corr_np"], 0, -1), self.N, self.d, nb)
            kd = kd + self._diag_band_np(cell_coeff, diag_b.reshape(nb, -1))
        return self.to_device(kd)

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


def _stiffness_diag_cells_np(G, N: int, d: int, num_cells: int) -> np.ndarray:
    """Per-cell diagonal entries of the stiffness matrix on the host:
    diag[c, i] = Σ_q Σ_ab B_a[q,i] G[c,q,ab] B_b[q,i] for the GLL-collocated
    basis (B_a is the Kronecker derivative along axis a, whose rows reduce
    to D along axis a and identity elsewhere). ``G`` [num_cells, N, ..., N,
    nsym] broadcasts over a leading axis of 1 or ``num_cells``."""
    Dnp = diff_matrix(N)
    sym = {pair: i for i, pair in enumerate(SYM_PAIRS[d])}
    diag = np.zeros((num_cells,) + (N,) * d)
    D2 = Dnp**2  # [q, n]
    for a in range(d):
        Gaa = G[..., sym[(a, a)]]
        diag += np.moveaxis(
            np.tensordot(np.moveaxis(Gaa, 1 + a, -1), D2, axes=([-1], [0])), -1, 1 + a)
    ddiag = np.diag(Dnp)
    for a in range(d):
        for b in range(a + 1, d):
            Gab = G[..., sym[(a, b)]]
            diag += 2.0 * Gab * np.expand_dims(
                ddiag, tuple(i for i in range(d) if i != a)
            ) * np.expand_dims(ddiag, tuple(i for i in range(d) if i != b))
    return diag
