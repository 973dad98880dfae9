"""Spectral-element operators: a uniform lattice (1D, 2D or 3D), a
bowl-fitted 3D lattice, or any conforming quad/hex mesh.

Port of ``fenicsxfus_tpu/ops/operators.py::SEMOperators``: with collocated
GLL quadrature every mass-type term is diagonal, so the lumped mass and the
boundary source/ABC vectors are assembled once on the host (numpy) and
applied as elementwise products; the stiffness runs the packed K1 form
(``ops/stiffness.py``) on a 3D lattice. On a 1D or 2D lattice, where the JAX
package has no Pallas kernel and runs ``LatticeStiffness.apply_scaled``, the
port runs its own d-generic ``apply_scaled`` (plain torch ops on the fields'
device) over the lattice scales of ``stiff_coeff``. ``stiffness_diag`` (the
Jacobi preconditioner of the implicit models) is an index-free host fold.

A bowl-fitted lattice (``core/bowl.py::create_bowl_box``: only its first
``blend_layers`` x-layers of cells are deformed, the rest is the uniform
box ``uniform_box``) takes the hybrid path of the JAX package: the stiffness
splits as K = K_uniform(whole lattice) + K_{c·(G_cell − G_uniform)}(slab),
the first term K1 on the uniform box's lattice and the second the slab
correction K6 (``ops/band.py``); the lumped mass and the stiffness diagonal
gain the slab's per-cell corrections the same way.

Every other mesh takes the general per-cell path, as in the JAX package: an
unstructured mesh (no ``grid_shape``: the entity-blocked numbering of
``core/space.py``), a deformed lattice that is not bowl-fitted, the bowl
mesh under ``FUS_HYBRID=0``, and a uniform lattice that is not axis-aligned.
Its stiffness is gather (``index_select`` through the dofmap) → per-cell
action → deterministic fold back onto the DOFs (``scatter``). The per-cell
action is the dense tabulation ``stiffness_cells_dense`` (two matmuls with
K = N**d) by default for d ≥ 2, the sum-factorised ``stiffness_cells`` with
``FUS_DENSE_TAB=0``, and one matmul with the shared element matrix
``K_ref`` on a uniform mesh. The fold sums each DOF's contributions in the
sorted plan's order, one valence class at a time (no atomics, so the same
input gives the same bits); ``stiffness_apply_generic``, the oracle, pins
the sum-factorised chain and the sorted segment sum (``scatter_segsum``),
so it shares neither with the default. No TPU kernel is on this path (the
JAX package runs it in XLA), so it is plain torch ops.

A coefficient given at the GLL nodes (the sponge layer's δ(x)) takes
``stiffness_apply_nodal``: on a lattice of any d the plain ``apply_scaled``
over ``pack_scales_nodal``'s scales (K1 takes only constant or DG-0
coefficients; the JAX package runs this term in XLA too), on the general
path the per-cell action with the coefficient's cell values at the
quadrature points (``qcoeff``).

Every assembled result passes through ``complete`` before it is returned:
the lattice K1 path, the 1D/2D ``apply_scaled``, the hybrid path, the nodal
apply and the folds ``scatter``/``scatter_segsum``. On one device it is the
identity; the slab and grid decompositions (``parallel/slab.py::
HaloSEMOperators``) override it with the neighbour halo exchange, and the
unstructured split (``parallel/unstructured.py::LocalUnstructuredOps``) with
the sum of its shared rows over the ranks, as the JAX package does.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ..analysis.timing import span, traced
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
    """Operator data for one function space: a uniform lattice (d = 1, 2
    or 3), a bowl-fitted 3D lattice, or the general per-cell path.

    Parameters
    ----------
    mesh : core.mesh.Mesh (``create_interval``, ``create_rectangle``,
        ``create_box``, ``create_bowl_box``, ``as_unstructured``, or any
        conforming quad/hex mesh)
    degree : polynomial degree p (GLL basis has N = p+1 nodes per axis)
    dtype : torch dtype of the device fields
    device : torch device of the fields (default the card; the CPU only
        when asked for)

    ``lattice`` is the ``LatticeStiffness`` of a uniform axis-aligned
    lattice or of a bowl-fitted one's uniform box, and ``gdims`` its shape;
    both are None on the general path. ``hybrid`` is None unless the
    lattice is bowl-fitted; then it holds the slab: ``bx`` cell layers,
    ``nb`` cells, their ``blocks`` per axis, ``slab_x`` lattice rows, the
    correction factors ``G_corr`` [6, nb, N, N, N] on the device and, on
    the host, the same factors ``G_corr_np`` in float64 and the mass
    correction ``wdetJ_corr_np`` [nb, N**3].

    ``stiffness_fn`` is the 3D stiffness function ``(xs, Fs, p) -> y``:
    ``ops.stiffness.stiffness_apply``, the K1 wrapper, unless ``plain()``
    made this copy, whose 3D stiffness is ``stiffness_plain`` on any device.
    """

    stiffness_fn = staticmethod(stiffness_apply)

    @traced("fus.setup.operators")
    def __init__(self, mesh, degree: int, dtype=torch.float32, device="cuda"):
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
        self.lattice = None
        self.gdims = None
        self._geom = None  # lazy (wdetJ_np, G_np); see _compute_geom
        self.D = self.to_device(diff_matrix(N))
        self.uniform = is_uniform_mesh(mesh)
        # the branch conditions of the JAX package's operators.py:78-114
        if self.uniform:
            self._setup_uniform()
        elif (mesh.grid_shape is not None and mesh.blend_layers and d == 3
              and mesh.uniform_box is not None and os.environ.get("FUS_HYBRID", "") != "0"):
            self._setup_hybrid(int(mesh.blend_layers))
        else:
            self._compute_geom()
        if self.lattice is not None:
            self.gdims = self.lattice.gdims
        self._facet_cache: dict[int, tuple] = {}

    def _setup_uniform(self):
        """A uniform mesh: the geometry of one cell (every cell is a
        translate of the first); the lattice operator when the mesh is a
        structured axis-aligned lattice, else the shared element matrix
        ``K_ref`` on the general path."""
        mesh, d = self.mesh, self.d
        _, G = self._compute_geom()
        if mesh.grid_shape is None:
            return
        diag = [i for i, (a, b) in enumerate(SYM_PAIRS[d]) if a == b]
        off = np.delete(G[0], diag, axis=-1)
        if off.size and np.max(np.abs(off)) >= 1e-12 * np.max(np.abs(G[0])):
            return
        lo = mesh.vertices.min(axis=0)
        hi = mesh.vertices.max(axis=0)
        h = [(hi[a] - lo[a]) / mesh.grid_shape[a] for a in range(d)]
        self.lattice = LatticeStiffness(mesh.grid_shape, self.degree, h, self.dtype)

    def _compute_geom(self):
        """(wdetJ_np [Nc|1, N**d], G_np [Nc|1, N**d, nsym]), host float64,
        with a leading axis of 1 on a uniform mesh (the first cell's). On
        the hybrid path this is the whole mesh's per-cell factors: oracle
        use only."""
        if self._geom is None:
            mesh = self.mesh
            if self.uniform:
                sub = Mesh(dim=self.d, vertices=mesh.vertices[mesh.cells[0]],
                           cells=np.arange(2**self.d, dtype=np.int64)[None, :])
                self._geom = volume_factors(sub, self.N)
            else:
                self._geom = volume_factors(mesh, self.N)
        return self._geom

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
        sub = Mesh(dim=d, vertices=mesh.vertices, cells=mesh.cells[:nb])
        wdetJ_b, G_b = volume_factors(sub, N)  # [nb, N**3], [nb, N**3, 6]
        wdetJ_u, G_u = volume_factors(_one_cell(lo_u, h), N)  # [1, ...]
        G_corr = np.moveaxis(G_b - G_u, -1, 0).reshape((6, nb) + (N,) * d)
        self.hybrid = {
            "bx": bx,
            "nb": nb,
            "blocks": blocks,
            "slab_x": bx * p + 1,
            "G_corr": self.to_device(G_corr),
            "G_corr_np": G_corr,
            "wdetJ_corr_np": wdetJ_b - wdetJ_u,
        }

    def to_device(self, arr) -> torch.Tensor:
        """A host array as a tensor of the operator dtype on its device."""
        with span("fus.setup.upload", sync=self.device):
            return torch.as_tensor(np.asarray(arr), dtype=self.dtype, device=self.device)

    # -------------------------------------------------------- diagonal (mass)

    def assemble_diag(self, cell_coeff) -> np.ndarray:
        """Assembled diagonal of the coefficient-weighted mass matrix on the
        host: m[i] = Σ_{cells c ∋ i} coeff_c · w_i · |detJ|_c(i)
        (reference lumped mass, ``_linear.py:348-353``); on a hybrid lattice
        the uniform box's fold plus the slab's per-cell correction, on the
        general path the per-cell values summed onto the DOFs in float64.
        Flat [ndofs], in the host counterpart of the device dtype."""
        if self.lattice is None:
            coeff = _cell_array_np(cell_coeff, self.num_cells)
            m = self._fold_np(coeff[:, None] * self._compute_geom()[0])
        else:
            m = self.lattice.mass_diag(np.asarray(cell_coeff)).reshape(-1)
            if self.hybrid is not None:
                m = m + self._diag_band_np(cell_coeff, self.hybrid["wdetJ_corr_np"])
        return np.asarray(m, numpy_dtype(self.dtype))

    def _fold_np(self, percell: np.ndarray) -> np.ndarray:
        """Host sum of per-cell nodal values [Nc|1, N**d] (broadcast over
        the cells) onto the DOFs through the dofmap: float64 [ndofs]."""
        vals = np.broadcast_to(percell.reshape(percell.shape[0], -1),
                               (self.num_cells, self.N**self.d))
        return np.bincount(self.space.dofmap.reshape(-1), weights=vals.reshape(-1),
                           minlength=self.ndofs)

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
        factors, shared by every coefficient}; on the general path the
        coefficient per cell, a [Nc] tensor."""
        if self.lattice is None:
            return self._cell_coeff(coeff)
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

    @traced("fus.band")
    def band_correction_rows(self, rows, band_coeffs, G) -> torch.Tensor:
        """The slab correction K6 (``ops/band.py``) of the fields' slab rows
        ``rows`` [slab_x, G1, G2] with the slab coefficients ``band_coeffs``
        and factors ``G``; returns the correction on the same rows."""
        hy = self.hybrid
        return band_correction_rows(rows, band_coeffs, G, self.D, hy["blocks"], self.degree)

    def stiffness_apply(self, xs, coeffs) -> torch.Tensor:
        """y = Σ_f K_{coeff_f}(x_f)  where K_c(u)·φ_i = ∫ c ∇u·∇φ_i dx.

        ``xs``: global vectors [ndofs] (or lattice-shaped); ``coeffs``:
        coefficients from ``stiff_coeff`` (on a hybrid lattice and on the
        general path raw DG-0 coefficients are prepared here). Returns a
        flat [ndofs] vector. On a 3D lattice ``stiffness_fn``: K1 (or K4a
        then K4b under ``FUS_V3=0``); on a 1D or 2D lattice
        ``LatticeStiffness.apply_scaled``. On a hybrid lattice: the same of
        the uniform parts, plus the slab correction K6 added onto the slab
        rows. On the general path: ``gather_combine``, the per-cell action
        (``K_ref`` on a uniform mesh, else ``_stiffness_cells``) and the
        deterministic fold ``scatter``."""
        if self.lattice is None:
            z = self.gather_combine(xs, coeffs)
            if self.K_ref is not None:
                nd = self.N**self.d
                y = torch.matmul(z.reshape(self.num_cells, nd), self.K_ref.T)
            else:
                y = self._stiffness_cells(z)
            return self.scatter(y)
        x3 = [x.reshape(self.gdims) for x in xs]
        if self.d != 3:
            return self.complete(self.lattice.apply_scaled(list(zip(x3, coeffs))).reshape(-1))
        if self.hybrid is None:
            return self.complete(self.stiffness_fn(x3, coeffs, self.degree).reshape(-1))
        cs = [self.stiff_coeff(c) for c in coeffs]
        y = self.stiffness_fn(x3, [c["hyb_u"] for c in cs], self.degree)
        sx = self.hybrid["slab_x"]
        y[:sx] += self.band_correction_rows(
            [x[:sx] for x in x3], [c["hyb_b"] for c in cs], cs[0]["hyb_G"])
        return self.complete(y.reshape(-1))

    def pack_scales_nodal(self, coeff_nodal) -> tuple:
        """The lattice scales of a nodal (per-DOF) coefficient on the device
        (the sponge layer's δ(x)): a tuple of the per-axis scale tensors of
        ``LatticeStiffness.scales_nodal``."""
        return tuple(self.to_device(t) for t in self.lattice.scales_nodal(np.asarray(coeff_nodal)))

    def stiffness_apply_nodal(self, xs, nodal_coeffs) -> torch.Tensor:
        """y = Σ_f K_{c_f(x)}(x_f) with coefficients given at the GLL nodes
        and evaluated at the (collocated) quadrature points: the spatially
        varying sponge-layer term ∫ δ(x) ∇v·∇φ dx (reference
        ``_experimental.py:898-918``). On a lattice of any d (the uniform
        box's lattice on a hybrid one, as in the JAX package)
        ``LatticeStiffness.apply_scaled`` over the nodal scales (packed by
        ``pack_scales_nodal``, or packed here from a raw [ndofs] array): K1
        takes only constant or DG-0 coefficients, and the JAX package runs
        this term in XLA too. On the general path the coefficient's cell
        values scale the flux at each quadrature point of
        ``_stiffness_cells`` (``qcoeff``), then the fold. Flat [ndofs]."""
        if self.lattice is not None:
            pairs = []
            for x, cn in zip(xs, nodal_coeffs):
                scales = cn if isinstance(cn, (tuple, list)) else self.pack_scales_nodal(cn)
                pairs.append((x.reshape(self.gdims), scales))
            return self.complete(self.lattice.apply_scaled(pairs).reshape(-1))
        y = None
        for x, cn in zip(xs, nodal_coeffs):
            cn = cn if isinstance(cn, torch.Tensor) else self.to_device(cn)
            yc = self._stiffness_cells(self.gather(x), qcoeff=self.gather(cn))
            y = yc if y is None else y + yc
        return self.scatter(y)

    def complete(self, y: torch.Tensor) -> torch.Tensor:
        """Finish a locally assembled vector. The identity on one device;
        the decompositions' operators add the other ranks' partial sums of
        the shared rows (the JAX package's ``complete``)."""
        return y

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
        the slab cells' corrections; on the general path each cell's
        diagonal summed onto the DOFs on the host. Flat [ndofs] on the
        device."""
        if self.lattice is None:
            d, N = self.d, self.N
            G = self._compute_geom()[1]
            diag = _stiffness_diag_cells_np(G.reshape((-1,) + (N,) * d + (G.shape[-1],)),
                                            N, d, self.num_cells)
            coeff = _cell_array_np(cell_coeff, self.num_cells).reshape((-1,) + (1,) * d)
            return self.to_device(self._fold_np(coeff * diag))
        kd = self.lattice.stiffness_diag(np.asarray(cell_coeff))
        if self.hybrid is not None:
            # the slab cells' stiffness-diagonal corrections [nb, N**3]
            nb = self.hybrid["nb"]
            diag_b = _stiffness_diag_cells_np(
                np.moveaxis(self.hybrid["G_corr_np"], 0, -1), self.N, self.d, nb)
            kd = kd + self._diag_band_np(cell_coeff, diag_b.reshape(nb, -1))
        return self.to_device(kd)

    # ------------------------------------------------------- the general path
    # Lazy: the lattice and hybrid paths never build these.

    def _cell_coeff(self, coeff) -> torch.Tensor:
        """A DG-0 coefficient (scalar, [Nc] array or tensor) as a [Nc]
        tensor of the operator dtype on its device."""
        if isinstance(coeff, torch.Tensor):
            t = coeff.to(device=self.device, dtype=self.dtype)
        else:
            t = self.to_device(np.asarray(coeff, np.float64))
        if t.ndim == 0:
            return t.expand(self.num_cells).contiguous()
        if tuple(t.shape) != (self.num_cells,):
            raise ValueError(f"DG-0 coefficient must be a scalar or [{self.num_cells}]")
        return t

    @property
    def G(self) -> torch.Tensor:
        """The geometry factors on the device, component-major [nsym,
        Nc|1, N, ..., N] (a leading cell axis of 1 on a uniform mesh)."""
        if not hasattr(self, "_G_dev"):
            G = self._compute_geom()[1]
            out = torch.empty((G.shape[-1], G.shape[0]) + (self.N,) * self.d,
                              dtype=self.dtype, device=self.device)
            for k in range(G.shape[-1]):  # one component at a time: no [Nc, Nq, nsym] copy
                out[k].copy_(torch.from_numpy(np.ascontiguousarray(G[:, :, k])).view(out[k].shape))
            self._G_dev = out
        return self._G_dev

    @property
    def gidx(self) -> torch.Tensor:
        """The dofmap on the device, int32 [Nc * N**d] (the gather's index)."""
        if not hasattr(self, "_gidx"):
            self._gidx = torch.as_tensor(self.space.dofmap.reshape(-1), dtype=torch.int32,
                                         device=self.device)
        return self._gidx

    @property
    def perm(self) -> torch.Tensor:
        """The sorted plan's permutation of the flat cell values (int64)."""
        if not hasattr(self, "_perm"):
            self._perm = torch.as_tensor(self.space.scatter_perm, dtype=torch.int64,
                                         device=self.device)
        return self._perm

    def _valences(self) -> np.ndarray:
        """How many cell values each DOF sums (host int64 [ndofs])."""
        return np.bincount(self.space.scatter_segids, minlength=self.ndofs)

    @property
    def seglens(self) -> torch.Tensor:
        """``_valences`` on the device: the segment lengths of the sorted
        plan."""
        if not hasattr(self, "_seglens"):
            self._seglens = torch.as_tensor(self._valences(), device=self.device)
        return self._seglens

    @property
    def fold_plan(self) -> list:
        """The deterministic fold, one entry per valence k (the number of
        cell values a DOF sums): (dofs [n_k] int64, table [n_k * k] int32),
        the table listing each of those DOFs' cell values in the sorted
        plan's order (cell-major)."""
        if not hasattr(self, "_fold_plan"):
            perm = self.space.scatter_perm
            lens = self._valences()
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            plan = []
            for k in np.unique(lens[lens > 0]):
                dofs = np.flatnonzero(lens == k)
                table = perm[starts[dofs][:, None] + np.arange(k)]
                plan.append((torch.as_tensor(dofs, dtype=torch.int64, device=self.device),
                             torch.as_tensor(table.reshape(-1), dtype=torch.int32,
                                             device=self.device)))
            self._fold_plan = plan
        return self._fold_plan

    @property
    def K_ref(self):
        """The dense element stiffness [N**d, N**d] shared by every cell of
        a uniform mesh (the general path's route there), else None."""
        if not hasattr(self, "_K_ref"):
            self._K_ref = None
            if self.uniform:
                K = _reference_stiffness_matrix(self.N, self.d, self._compute_geom()[1][0])
                self._K_ref = self.to_device(K)
        return self._K_ref

    @property
    def B_tab(self) -> torch.Tensor:
        """The dense gradient tabulation [d, N**d, N**d] (``tabulate_B``)."""
        if not hasattr(self, "_B_tab"):
            self._B_tab = self.to_device(tabulate_B(self.N, self.d))
        return self._B_tab

    def _use_dense_tab(self) -> bool:
        return self.d >= 2 and os.environ.get("FUS_DENSE_TAB", "1") != "0"

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The cell values of a global vector: [Nc, N, ..., N]."""
        return x.reshape(-1).index_select(0, self.gidx).view((self.num_cells,) + (self.N,) * self.d)

    def scatter(self, ycells: torch.Tensor) -> torch.Tensor:
        """Deterministic cell→global additive assembly: per valence class
        of ``fold_plan``, each DOF's cell values gathered in the sorted
        plan's order and summed along a row (no atomics: the same input
        gives the same bits). Flat [ndofs]."""
        flat = ycells.reshape(-1)
        y = flat.new_zeros(self.ndofs)
        for dofs, table in self.fold_plan:
            k = table.numel() // dofs.numel()
            y.index_copy_(0, dofs, flat.index_select(0, table).view(-1, k).sum(1))
        return self.complete(y)

    def scatter_segsum(self, ycells: torch.Tensor) -> torch.Tensor:
        """Sorted segment-sum assembly (the oracle of ``scatter``, the JAX
        package's ``segment_sum`` over the sorted plan)."""
        flat = ycells.reshape(-1).index_select(0, self.perm)
        return self.complete(torch.segment_reduce(flat, "sum", lengths=self.seglens))

    def gather_combine(self, xs, coeffs) -> torch.Tensor:
        """Gather fields and combine with per-cell DG-0 coefficients:
        z_c = Σ_f coeff[f, c] · x_f[dofmap[c]].   [Nc, N, ...]"""
        z = None
        shape = (-1,) + (1,) * self.d
        for x, coeff in zip(xs, coeffs):
            term = self._cell_coeff(coeff).view(shape) * self.gather(x)
            z = term if z is None else z + term
        return z

    def _stiffness_cells(self, z: torch.Tensor, qcoeff=None) -> torch.Tensor:
        """Per-cell stiffness action on gathered fields: the dense
        tabulation by default (``stiffness_cells_dense``), the
        sum-factorised chain with ``FUS_DENSE_TAB=0``. ``qcoeff`` [Nc, N,
        ..., N], if given, scales the flux at each quadrature point (the
        nodal-coefficient apply)."""
        if self._use_dense_tab():
            return stiffness_cells_dense(self.B_tab, self.G, z, self.d, qcoeff)
        return stiffness_cells(self.D, self.G, z, self.d, qcoeff)

    def stiffness_apply_generic(self, xs, coeffs) -> torch.Tensor:
        """The oracle of every stiffness path: gather, the sum-factorised
        ``stiffness_cells`` and the sorted segment sum, pinned so that the
        oracle and the default share neither the cell route nor the fold.
        Takes raw DG-0 coefficients."""
        z = self.gather_combine(xs, coeffs)
        return self.scatter_segsum(stiffness_cells(self.D, self.G, z, self.d))

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


def _cell_array_np(coeff, num_cells: int) -> np.ndarray:
    """A DG-0 coefficient (scalar or [Nc]) as a float64 [Nc] host array."""
    arr = np.asarray(coeff, np.float64)
    if arr.ndim == 0:
        return np.full(num_cells, float(arr))
    if arr.shape != (num_cells,):
        raise ValueError(f"DG-0 coefficient must be a scalar or [{num_cells}]")
    return arr


def tabulate_B(N: int, d: int) -> np.ndarray:
    """Dense gradient tabulation B[a, q, n] = ∂_a φ_n(ξ_q) on the GLL
    lattice (Kronecker of the 1D differentiation matrix along axis ``a``
    with identities elsewhere) — the reference's precomputed-basis
    tabulation (``cpp/fenicsx-pc/common/precompute_op.hpp:18-33``)."""
    Dm = diff_matrix(N)
    eye = np.eye(N)
    Bs = []
    for a in range(d):
        mats = [Dm if ax == a else eye for ax in range(d)]
        B = mats[0]
        for m in mats[1:]:
            B = np.einsum("qn,rm->qrnm", B, m).reshape(
                B.shape[0] * m.shape[0], B.shape[1] * m.shape[1]
            )
        Bs.append(B)
    return np.stack(Bs)  # [d, N^d, N^d]


def stiffness_cells_dense(B: torch.Tensor, G: torch.Tensor, z: torch.Tensor,
                          d: int, qcoeff=None) -> torch.Tensor:
    """Per-cell stiffness action through the dense shared gradient
    tabulation: y_c = Bᵀ (G_c ∘ (B z_c)), the reference's dense-tabulation
    rung (``fenicsx-pc``, ``precompute_op.hpp:294-486``). Two matmuls
    [Nc, N^d] @ [N^d, d·N^d] and back, and the symmetric-G transform
    between them. ``B`` [d, N^d, N^d], ``G`` [nsym, Nc|1, N, ..., N];
    ``qcoeff`` [Nc, N, ..., N], if given, scales each flux component at the
    quadrature points."""
    nc = z.shape[0]
    nd = B.shape[-1]
    Bf = B.reshape(d * nd, nd)
    du = torch.matmul(z.reshape(nc, nd), Bf.T).view(nc, d, nd)  # [Nc, d, Nq]
    Gf = G.reshape(G.shape[0], G.shape[1], nd)
    sym = {pair: i for i, pair in enumerate(SYM_PAIRS[d])}
    gq = torch.empty_like(du)
    for a in range(d):
        g = Gf[sym[(0, a)]] * du[:, 0]
        for b in range(1, d):
            g = torch.addcmul(g, Gf[sym[(min(a, b), max(a, b))]], du[:, b])
        gq[:, a] = g if qcoeff is None else g * qcoeff.reshape(nc, nd)
    return torch.matmul(gq.view(nc, d * nd), Bf).view(z.shape)


def stiffness_cells(D: torch.Tensor, G: torch.Tensor, z: torch.Tensor, d: int,
                    qcoeff=None) -> torch.Tensor:
    """Sum-factorised per-cell stiffness action (reference
    ``cpp/fenicsx-sf/common/spectral_op.hpp:173-243``): forward
    D-contractions per axis, the symmetric-G quadrature transform,
    transposed D-contractions. ``G`` [nsym, Nc|1, N, ..., N]; ``qcoeff``
    [Nc, N, ..., N], if given, scales each flux component at the
    quadrature points."""
    s = (lambda g: g * qcoeff) if qcoeff is not None else (lambda g: g)  # noqa: E731
    if d == 1:
        du = torch.einsum("qi,ci->cq", D, z)
        return torch.einsum("qi,cq->ci", D, s(G[0] * du))
    if d == 2:
        d0 = torch.einsum("qi,cij->cqj", D, z)
        d1 = torch.einsum("qj,cij->ciq", D, z)
        g0 = s(G[0] * d0 + G[1] * d1)
        g1 = s(G[1] * d0 + G[2] * d1)
        return torch.einsum("qi,cqj->cij", D, g0) + torch.einsum("qj,ciq->cij", D, g1)
    d0 = torch.einsum("qi,cijk->cqjk", D, z)
    d1 = torch.einsum("qj,cijk->ciqk", D, z)
    d2 = torch.einsum("qk,cijk->cijq", D, z)
    g0 = s(G[0] * d0 + G[1] * d1 + G[2] * d2)
    g1 = s(G[1] * d0 + G[3] * d1 + G[4] * d2)
    g2 = s(G[2] * d0 + G[4] * d1 + G[5] * d2)
    return (torch.einsum("qi,cqjk->cijk", D, g0)
            + torch.einsum("qj,ciqk->cijk", D, g1)
            + torch.einsum("qk,cijq->cijk", D, g2))


def _reference_stiffness_matrix(N: int, d: int, G0: np.ndarray) -> np.ndarray:
    """Dense element stiffness K_ref[n, m] = Σ_q Σ_ab B_a[q,n] G[q,ab] B_b[q,m]
    for the (shared) geometry factors ``G0`` [Nq, nsym] of a uniform mesh."""
    Bs = tabulate_B(N, d)
    K = np.zeros((N**d, N**d))
    for idx, (a, b) in enumerate(SYM_PAIRS[d]):
        g = G0[:, idx]
        K += np.einsum("qn,q,qm->nm", Bs[a], g, Bs[b])
        if a != b:
            K += np.einsum("qn,q,qm->nm", Bs[b], g, Bs[a])
    return K
