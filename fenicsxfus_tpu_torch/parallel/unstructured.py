"""Decomposition of unstructured conforming quad/hex meshes over the ranks of
a ``torch.distributed`` process group.

Port of ``fenicsxfus_tpu/parallel/unstructured.py``: the reference partitions
any mesh at read time and runs every solver distributed
(``cpp/fenicsx-sf/tests/test_operators3d/main.cpp:31``; the ghost exchange
``cpp/fenicsx-sf/common/Linear.hpp:196-206``). The lattice decompositions
(``parallel/slab.py``, ``parallel/grid.py``) cover structured meshes; this
one covers the entity-blocked numbering of ``core/space.py``.

* Cells are split into contiguous chunks of a 1D cell order, the JAX
  package's partition cell for cell (``partition_tables``, a plain host
  function): by centroid along the longest bounding-box axis (``axis``) or
  along a Morton curve (``morton``); ``auto`` takes whichever replicates
  fewer vertices.
* A rank holds its own cells only (no padding: every process runs its own
  program, so nothing needs uniform shapes) and the DOFs they touch,
  numbered in ascending global order. A rank may hold no cells at all; it
  still joins every collective.
* The local apply is the general per-cell path of ``SEMOperators`` on the
  rank's cells: gather, ``stiffness_cells_dense`` (``stiffness_cells``
  under ``FUS_DENSE_TAB=0``) and the deterministic valence-class fold.
  ``complete`` then adds the rows that other ranks share: the rank's rows
  go into a compact buffer of every shared DOF, the buffer is summed over
  the ranks (one ``all_reduce``, whatever the sharing pattern: the
  ``scatter_rev(+)`` analogue for arbitrary partitions) and the sums are
  written back. Every holder of a DOF then has the same bits.
* The CG of the implicit path weights each DOF by 1/(its number of holders)
  and sums the local dots over the ranks.

No TPU kernel is on this path (the JAX package runs it in XLA): it is torch
ops. The JAX package's wide gathers, 0/1 placement matmuls and
``FUS_BLOCKED`` schedules work around the TPU and have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.geometry import volume_factors
from ..core.gll import diff_matrix
from ..core.mesh import Mesh, _morton_codes
from ..core.space import build_space
from ..ops.operators import SEMOperators
from ..utils import resolve_device
from .slab import ShardedExplicitSolver, ShardedImplicitSolver, _Decomposition, _Exchange

PARTITIONS = ("auto", "axis", "morton")


def _blocked_space(mesh, degree: int, space=None):
    """The mesh's function space with the entity-blocked numbering, or a
    refusal (1D and structured meshes number their DOFs on the lattice)."""
    space = space or build_space(mesh, degree)
    _ = space.dofmap  # resolves the numbering (sets conn on the blocked path)
    if getattr(space, "conn", None) is None:
        raise ValueError(
            "unstructured decomposition needs the blocked numbering (2D/3D conforming mesh); "
            "1D/structured meshes use parallel.slab / parallel.grid")
    return space


def _check_partition(partition: str) -> None:
    if partition not in PARTITIONS:
        raise ValueError(f"unknown partition mode {partition!r}")


def partition_tables(mesh, degree: int, ndev: int, partition: str = "auto", space=None) -> dict:
    """The JAX package's partition of ``mesh`` over ``ndev`` ranks, on the
    host, with no process group: ``cell_ids`` [ndev, nc_loc] (rank q's cells
    in partition order, padded to nc_loc = ceil(Nc / ndev) with its last cell,
    or with the last cell of the order where it has none), ``cell_valid``
    [ndev, nc_loc], ``partition_mode`` (``auto`` resolved), ``nc_loc``, the
    shared face, edge and vertex counts ``nsf``/``nse``/``nsv`` and
    ``shared_payload``, the rows the JAX package's completion sums per apply
    (its padding rows count as touches, as there)."""
    space = _blocked_space(mesh, degree, space)
    _check_partition(partition)
    ndev = int(ndev)
    conn = space.conn
    d, m = mesh.dim, space.N - 2
    nc = mesh.num_cells
    cells = np.asarray(mesh.cells)
    cents = mesh.vertices[cells].mean(axis=1)
    ext = mesh.vertices.max(axis=0) - mesh.vertices.min(axis=0)
    nc_loc = -(-nc // ndev)

    def shared_vertices(order):
        touch = np.zeros(mesh.num_vertices, np.int32)
        for q in range(ndev):
            touch[np.unique(cells[order[q * nc_loc:(q + 1) * nc_loc]])] += 1
        return int(np.count_nonzero(touch >= 2))

    cand = {}
    if partition in ("auto", "axis"):
        cand["axis"] = np.argsort(cents[:, int(np.argmax(ext))], kind="stable")
    if partition in ("auto", "morton"):
        cand["morton"] = np.argsort(_morton_codes(cents), kind="stable")
    if partition == "auto":
        if ndev == 1:
            partition = "axis"
        else:
            partition = ("axis" if shared_vertices(cand["axis"]) <= shared_vertices(cand["morton"])
                         else "morton")
    order = cand[partition]
    cell_ids = np.empty((ndev, nc_loc), np.int64)
    valid = np.zeros((ndev, nc_loc), bool)
    for q in range(ndev):
        chunk = order[q * nc_loc:(q + 1) * nc_loc]
        cell_ids[q, : len(chunk)] = chunk
        cell_ids[q, len(chunk):] = chunk[-1] if len(chunk) else order[-1]
        valid[q, : len(chunk)] = True

    def nshared(gtab, n_global):
        touch = np.zeros(n_global, np.int32)
        for q in range(ndev):
            touch[np.unique(gtab[cell_ids[q]])] += 1
        return int(np.count_nonzero(touch >= 2))

    single = ndev == 1  # nothing is shared
    nsf = 0 if single or not (d >= 2 and m > 0) else nshared(np.asarray(conn.face_ids),
                                                             conn.num_faces)
    nse = 0 if single or not (d == 3 and m > 0) else nshared(np.asarray(conn.edge_ids),
                                                             conn.num_edges)
    nsv = 0 if single else nshared(cells.astype(np.int64), mesh.num_vertices)
    payload = nsf * (m ** (d - 1) if (d >= 2 and m > 0) else 0) + nse * m + nsv
    return {"cell_ids": cell_ids, "cell_valid": valid, "partition_mode": partition,
            "nc_loc": nc_loc, "nsf": nsf, "nse": nse, "nsv": nsv, "shared_payload": payload}


def rank_dofs(dofmap: np.ndarray, tables: dict, q: int, ndofs: int) -> np.ndarray:
    """The sorted distinct global DOFs of rank ``q``'s cells (``tables``:
    ``partition_tables``'s; no padding cells)."""
    mask = np.zeros(ndofs, bool)
    mask[dofmap[tables["cell_ids"][q][tables["cell_valid"][q]]].reshape(-1)] = True
    return np.flatnonzero(mask)


def holder_weights(dofmap: np.ndarray, tables: dict, ndofs: int) -> list:
    """Per rank, the dot weight of each of its ``rank_dofs``: 1/(the number
    of ranks that hold the DOF)."""
    dofs = [rank_dofs(dofmap, tables, q, ndofs) for q in range(len(tables["cell_ids"]))]
    count = np.zeros(ndofs)
    for d in dofs:
        count[d] += 1.0
    return [1.0 / count[d] for d in dofs]


class _LocalSpace:
    """The slice of a function space that the general path's gather and
    fold read: a rank's local dofmap and its sorted plan (as
    ``FunctionSpace._scatter_plan`` builds it)."""

    def __init__(self, dofmap: np.ndarray):
        self.dofmap = dofmap
        flat = dofmap.reshape(-1)
        self.scatter_perm = np.argsort(flat, kind="stable").astype(np.int32)
        self.scatter_segids = flat[self.scatter_perm].astype(np.int32)


class LocalUnstructuredOps(SEMOperators):
    """A rank's operators: the general per-cell path of ``SEMOperators`` on
    its own cells and the DOFs they touch (local numbering), whose assembly
    hook ``complete`` sums the shared rows over the ranks. Built by
    ``UnstructuredDecomposition``."""

    @classmethod
    def for_cells(cls, mesh, degree: int, cells: np.ndarray, dofmap: np.ndarray, ndofs: int,
                  dtype, device, model_ops=None):
        """The operators of ``cells`` (sorted global ids) of ``mesh``, with
        ``dofmap`` their local DOFs [len(cells), N**d]. The geometry factors
        are those of the global operators ``model_ops``, sliced, or without
        them computed for these cells. A rank that holds every cell numbers
        its DOFs as the global operators do, and shares their device
        tables."""
        self = object.__new__(cls)
        self.mesh, self.degree, self.dtype, self.device = None, degree, dtype, device
        self.d, self.N = mesh.dim, degree + 1
        self.ndofs, self.num_cells = int(ndofs), len(cells)
        self.hybrid = self.lattice = self.gdims = None
        self.uniform = False
        self._K_ref = None  # the per-cell route on every mesh, as the JAX package's split
        self._facet_cache = {}
        self.D = self.to_device(diff_matrix(self.N))
        whole = model_ops is not None and self.num_cells == model_ops.num_cells
        if model_ops is None:
            self._geom = volume_factors(Mesh(dim=mesh.dim, vertices=mesh.vertices,
                                             cells=np.asarray(mesh.cells)[cells]), self.N)
        else:
            wdetJ, G = model_ops._compute_geom()
            # a uniform mesh's one cell, or every cell in order, as they are
            self._geom = (wdetJ, G) if G.shape[0] == 1 or whole else (wdetJ[cells], G[cells])
        self.space = model_ops.space if whole else _LocalSpace(dofmap)
        if whole and model_ops.device == device and model_ops.dtype == dtype:
            for attr in ("_G_dev", "_gidx", "_fold_plan", "_B_tab", "_perm", "_seglens"):
                if attr in model_ops.__dict__:
                    setattr(self, attr, model_ops.__dict__[attr])
        self._world = 1
        return self

    def configure_shared(self, exchange: _Exchange, loc: np.ndarray, slot: np.ndarray,
                         nslots: int):
        """Rows ``loc`` of this rank are slots ``slot`` of the shared-row
        buffer, which has ``nslots`` rows on every rank."""
        self._exchange, self._world, self._nslots = exchange, exchange.world, int(nslots)
        self._loc = torch.as_tensor(loc, dtype=torch.int64, device=self.device)
        self._slot = torch.as_tensor(slot, dtype=torch.int64, device=self.device)

    def complete(self, y):
        """Sum the shared rows over the ranks: this rank's rows into the
        compact buffer, one ``all_reduce``, the sums written back."""
        if self._world == 1 or self._nslots == 0:
            return y
        buf = y.new_zeros(self._nslots)
        buf.index_copy_(0, self._slot, y.index_select(0, self._loc))
        buf = self._exchange.allreduce_sum(buf)
        y.index_copy_(0, self._loc, buf.index_select(0, self._slot))
        return y


class UnstructuredDecomposition(_Decomposition):
    """The partition of an unstructured conforming mesh over the ranks of
    the default process group, as seen from this rank: its cells (``cells``,
    sorted global ids), its DOFs (``l2g``, sorted global ids), its operators
    (``ops``) and the shared-row tables of ``complete``. ``cell_ids``,
    ``cell_valid``, ``partition_mode``, ``nc_loc`` and ``shared_payload``
    are ``partition_tables``'s; ``shared_rows`` is the number of DOFs that
    the ranks' own cells share (the completion buffer's rows; the JAX
    package's ``shared_payload`` also counts the touches of its padding
    cells, so the two differ only where a rank has no cells).

    ``model_ops`` (the global model's operators) lends its geometry
    factors; without it they are computed for this rank's cells alone."""

    def __init__(self, mesh, degree: int, ndev=None, dtype=torch.float32, space=None,
                 partition: str = "auto", device="cuda", model_ops=None):
        device = resolve_device(device)
        space = _blocked_space(mesh, degree, space)
        _check_partition(partition)
        self.exchange = _Exchange()
        world, rank = self.exchange.world, self.exchange.rank
        if ndev is not None and int(ndev) != world:
            raise ValueError(f"ndev={ndev}, but the process group has {world} ranks "
                             "(one rank holds one part)")
        self.mesh, self.degree, self.space = mesh, degree, space
        self.ndev, self.rank = world, rank
        self.dtype, self.device = dtype, device
        self.ndofs = space.ndofs
        tables = partition_tables(mesh, degree, world, partition, space)
        self.tables = tables
        self.cell_ids, self.cell_valid = tables["cell_ids"], tables["cell_valid"]
        self.partition_mode, self.nc_loc = tables["partition_mode"], tables["nc_loc"]
        self.shared_payload = tables["shared_payload"]
        self.cells = np.sort(self._rank_cells(rank))
        dofmap = np.asarray(space.dofmap)
        self.l2g = rank_dofs(dofmap, tables, rank, self.ndofs)
        g2l = np.full(self.ndofs, -1, np.int64)
        g2l[self.l2g] = np.arange(self.l2g.size)
        self.local_ndofs = int(self.l2g.size)
        self.ops = LocalUnstructuredOps.for_cells(mesh, degree, self.cells, g2l[dofmap[self.cells]],
                                                  self.local_ndofs, dtype, device, model_ops)
        # each DOF's lowest and highest holding rank: shared where they differ;
        # the lowest holder owns it (its value goes into gather_global)
        lo = np.full(self.ndofs, world, np.int64)
        hi = np.full(self.ndofs, -1, np.int64)
        for q in range(world):
            dofs = dofmap[self._rank_cells(q)].reshape(-1)
            lo[dofs] = np.minimum(lo[dofs], q)
            hi[dofs] = q
        self._owner = lo
        shared = lo != hi
        self.shared_rows = int(np.count_nonzero(shared))
        loc = np.flatnonzero(shared[self.l2g])
        slot = (np.cumsum(shared) - 1)[self.l2g[loc]]
        self.ops.configure_shared(self.exchange, loc, slot, self.shared_rows)
        self._l2g_t = torch.as_tensor(self.l2g, dtype=torch.int64, device=device)
        if world > 1:
            self._counts = np.bincount(lo, minlength=world)
            self._own_t = torch.as_tensor(np.flatnonzero(lo[self.l2g] == rank),
                                          dtype=torch.int64, device=device)
            self._order_t = torch.as_tensor(np.argsort(lo, kind="stable"), dtype=torch.int64,
                                            device=device)

    def _rank_cells(self, q: int) -> np.ndarray:
        """Rank ``q``'s cells in partition order (no padding)."""
        return self.cell_ids[q][self.cell_valid[q]]

    # ---- global <-> local DOF vectors -------------------------------------

    def to_local(self, vec, pad_value: float = 0.0) -> torch.Tensor:
        """This rank's DOFs [local_ndofs] of a global DOF vector ``vec``
        (array or tensor, [ndofs]) on this rank's device (no padding:
        ``pad_value`` is unused)."""
        t = torch.as_tensor(vec).reshape(-1)
        return t.index_select(0, self._l2g_t.to(t.device)).to(device=self.device,
                                                                dtype=self.dtype)

    def gather_global(self, local: torch.Tensor) -> torch.Tensor:
        """The global vector [ndofs] on every rank (a collective): each DOF
        from its lowest holder (the holders' values are the same bits)."""
        if self.ndev == 1:
            return local
        own = local.index_select(0, self._own_t)
        buf = local.new_zeros(int(self._counts.max()))
        buf[: own.numel()] = own
        every = self.exchange.all_gather(buf)
        flat = torch.cat([every[q, : int(c)] for q, c in enumerate(self._counts)])
        return local.new_empty(self.ndofs).index_copy_(0, self._order_t, flat)

    def locate_dofs(self, gdofs):
        """Global DOF indices → (holding rank, index into that rank's local
        DOF vector): each DOF goes to its lowest holder (the replicas are
        kept identical by the completion)."""
        g = np.asarray(gdofs, np.int64).reshape(-1)
        if g.size and (g.min() < 0 or g.max() >= self.ndofs):
            raise ValueError("sensor DOF has no authoritative row")
        dev = self._owner[g]
        slot = np.zeros(g.size, np.int64)
        for q in np.unique(dev):
            l2g = self.l2g if q == self.rank else rank_dofs(
                np.asarray(self.space.dofmap), self.tables, int(q), self.ndofs)
            slot[dev == q] = np.searchsorted(l2g, g[dev == q])
        return dev, slot

    def dot_weights(self) -> torch.Tensor:
        """This rank's DOF weights [local_ndofs]: 1/(the number of ranks
        holding the DOF), making the sum over ranks of Σ_i w·a·b the global
        inner product."""
        w = holder_weights(np.asarray(self.space.dofmap), self.tables, self.ndofs)[self.rank]
        return torch.as_tensor(w, dtype=self.dtype, device=self.device)

    def _local_cells(self, arr_cells) -> np.ndarray:
        """This rank's cells of a global [Nc] cell array (host float64)."""
        return np.asarray(arr_cells, np.float64).reshape(-1)[self.cells]

    def _pack_stiff_coeff(self, coeff):
        """A DG-0 stiffness coefficient on this rank's cells, a [cells]
        tensor (the general path takes it per cell)."""
        return self.ops._cell_coeff(self._local_cells(coeff))

    def _pack_nodal_coeff(self, nodal):
        """A nodal coefficient (the sponge's δ) at this rank's DOFs."""
        return self.to_local(np.asarray(nodal, np.float64))


class _UnstructuredSolver:
    """What the unstructured explicit and implicit solvers add to the
    lattice ones: the decomposition, and sensors located on the true cells
    (the model's interpolation tables) and read from their lowest holder."""

    def _make_dec(self, model, ndev, device):
        return UnstructuredDecomposition(model.mesh, model.degree, ndev, model.dtype,
                                         space=model.ops.space, partition=self._partition,
                                         device=device, model_ops=model.ops)

    def _sensor_slots(self, points):
        rows, wts = self.model.sensor_interp_tables(points)
        if np.all(np.abs(wts).max(axis=1) >= 1.0 - 1e-9):
            gdofs, wts = rows[np.arange(len(rows)), np.abs(wts).argmax(axis=1)], None
        else:
            gdofs = rows.reshape(-1)
        dev, slot = self.dec.locate_dofs(gdofs)
        return dev, slot, wts


class ShardedUnstructuredExplicitSolver(_UnstructuredSolver, ShardedExplicitSolver):
    """Run an explicit model's unfused step over the ranks on an
    unstructured mesh, each rank its own cells (``rk``, ``rk_record``).

    Usage, on every rank::

        model = WesterveltSpectralExplicit(mesh, ..., device=device)   # global setup
        sharded = ShardedUnstructuredExplicitSolver(model, device=device)
        u, v, t = sharded.rk(t0, tf)                                    # == model.rk(t0, tf)
    """

    def __init__(self, model, ndev=None, partition: str = "auto", device="cuda"):
        self._partition = partition
        super().__init__(model, ndev, device)


class ShardedUnstructuredImplicitSolver(_UnstructuredSolver, ShardedImplicitSolver):
    """SDIRK on an unstructured mesh over the ranks: each rank's CG applies
    its cells' ``lhs_pure`` (completed over the shared rows) and sums its
    holder-weighted dots over the ranks (``dirk``, ``dirk_record``)."""

    def __init__(self, model, ndev=None, partition: str = "auto", device="cuda"):
        self._partition = partition
        super().__init__(model, ndev, device)
