"""Slab domain decomposition over ``torch.distributed`` ranks.

Port of ``fenicsxfus_tpu/parallel/slab.py`` (the reference's MPI layer,
DOLFINx ``scatter_fwd``/``scatter_rev(+)`` around every operator apply,
``cpp/fenicsx-sf/common/Linear.hpp:196-206``). The JAX package runs one
program over a device mesh (``shard_map``); here each rank is a process
(``parallel/launch.py``) that holds only its own slab:

* the structured mesh is split along axis 0 into contiguous slabs, one per
  rank of the default process group (``ndev`` is its world size);
* interface DOF planes are replicated on both neighbours, and every
  mass-type diagonal is assembled globally once, so pointwise updates keep
  the replicas identical;
* the only communication of a step is completing the stiffness assembly:
  after its local apply each rank sends its two interface planes to its
  neighbours and adds the planes it receives (``HaloSEMOperators.complete``,
  the ``scatter_rev(+)`` analogue), always the left neighbour's plane first
  and then the right's, with no atomics;
* the CG of the implicit path sums an interface-weighted local dot over the
  ranks (``dist.all_reduce``), so every rank reads the same ‖r‖² and takes
  the same iterations.

Transport, chosen by the group's backend: NCCL sends the device tensors
(``dist.batch_isend_irecv``, ``all_reduce``, ``all_gather_into_tensor``);
gloo sends host tensors, so planes of a field on the card are copied
through host buffers (gloo sends no CUDA tensors). Any other backend is
refused, and a failed exchange raises.

Cell counts need not divide the world size: the last slabs are padded with
inert cells (zero stiffness coefficient, zero fields, dot weight 0, 1 on the
diagonals the solver divides by), so every rank holds the same local
lattice. Each rank's local operators are those of the first slab (the
lattice is uniform); only the coefficients and diagonal vectors differ.

A bowl-fitted mesh (``core/bowl.py``) keeps the lattice path when its blend
band fits inside rank 0's slab: rank 0's local operators are hybrid (K1 plus
the slab correction K6), the other ranks' the uniform lattice's (the JAX
package gives them zero band tables, which make K6 an exact no-op).

``SlabDecomposition`` is the one-axis case of ``GridDecomposition``, the
block decomposition over a grid of ranks that ``parallel/grid.py`` exports:
the lattice bookkeeping, the halo exchange and the streamed build
(``build_streamed``) are the grid's, and the slab adds only the bowl.

``ShardedExplicitSolver`` runs the model's unfused step (``rhs_pure``, K1
once per stage on each rank's slab), ``ShardedImplicitSolver`` its SDIRK
step (``dirk_step`` with the reduced dot; fp64 K1 in the CG), both from
step start times held in float64 on the host. ``rk``/``dirk`` return the
global state on every rank; ``build_sharded`` builds each rank's slab alone
from a model factory and keeps only the local state (``global_result``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.gll import gll_points_weights_01, lagrange_eval_gll
from ..core.mesh import Mesh, _structured
from ..models.common import run_steps, step_sizes
from ..ops.lattice import LatticeStiffness
from ..ops.operators import SEMOperators
from ..utils import resolve_device

# consts of a model's fused step (packed facet vectors, a separable inv_m):
# the sharded step is the unfused one and never reads them
FUSED_STEP_SUFFIXES = ("__pf", "__sep0", "__sepP")


class _Exchange:
    """The rank-to-rank transport of the default process group."""

    def __init__(self):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "the slab decomposition needs an initialised torch.distributed process "
                "group: start ranks with parallel.launch.spawn, or make one with "
                "parallel.launch.process_group")
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.backend = str(dist.get_backend())
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"the slab decomposition runs on gloo or nccl, not {self.backend}")

    def _host(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    def exchange(self, first: torch.Tensor, last: torch.Tensor, prev, nxt):
        """One neighbour exchange: this rank's ``first`` plane goes to rank
        ``prev`` and its ``last`` plane to rank ``nxt`` (None: no such
        peer). Returns (``prev``'s last plane, ``nxt``'s first plane), None
        where there is no peer."""
        host = self._host(first)
        ops, recv = [], {}
        for side, peer, plane in (("prev", prev, first), ("next", nxt, last)):
            if peer is not None:
                buf = plane.cpu().contiguous() if host else plane.contiguous()
                recv[side] = torch.empty_like(buf)
                ops += [dist.P2POp(dist.isend, buf, peer), dist.P2POp(dist.irecv, recv[side], peer)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        back = (lambda t: t.to(first.device)) if host else (lambda t: t)  # noqa: E731
        return (back(recv["prev"]) if "prev" in recv else None,
                back(recv["next"]) if "next" in recv else None)

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, on every rank."""
        if self.world == 1:
            return t
        if self._host(t):
            h = t.cpu()
            dist.all_reduce(h)
            return h.to(t.device)
        dist.all_reduce(t)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order, [world, *t.shape]."""
        if self.world == 1:
            return t[None]
        if self.backend == "nccl":
            out = t.new_empty((self.world,) + tuple(t.shape))
            dist.all_gather_into_tensor(out, t.contiguous())
            return out
        h = t.contiguous().cpu()
        parts = [torch.empty_like(h) for _ in range(self.world)]
        dist.all_gather(parts, h)
        return torch.stack(parts).to(t.device)


class HaloSEMOperators(SEMOperators):
    """SEMOperators on a rank's local block whose assembly hook
    ``complete`` adds the neighbours' interface-plane partial sums (the JAX
    package's ``ppermute`` exchanges): one neighbour exchange per
    partitioned axis in turn, axis 0 first, each adding the previous
    neighbour's plane and then the next one's to the sums of the exchanges
    before it, so the later axes carry the edge and corner sums. Rank r is
    the block ``np.unravel_index(r, dshape)``; the slab is the grid of one
    axis. The identity at world size 1."""

    def configure_halo(self, exchange: _Exchange, dshape, Ls, rest: int):
        self._exchange = exchange
        self._dshape = tuple(dshape)
        self._Ls = tuple(Ls)  # local lattice rows along each partitioned axis
        self._rest = rest  # DOFs per row of the partitioned axes
        self._didx = np.unravel_index(exchange.rank, self._dshape)

    def _peer(self, axis: int, step: int):
        """The rank of the block ``step`` blocks along ``axis`` from this
        one, or None past the grid's edge."""
        idx = list(self._didx)
        idx[axis] += step
        if not 0 <= idx[axis] < self._dshape[axis]:
            return None
        return int(np.ravel_multi_index(tuple(idx), self._dshape))

    def complete(self, y):
        ex = self._exchange
        if ex.world == 1:
            return y
        y3 = y.reshape(self._Ls + (self._rest,))
        for ax, dn in enumerate(self._dshape):
            if dn <= 1:
                continue
            lo = (slice(None),) * ax + (0,)
            hi = (slice(None),) * ax + (-1,)
            from_prev, from_next = ex.exchange(y3[lo], y3[hi], self._peer(ax, -1),
                                               self._peer(ax, 1))
            if from_prev is not None:
                y3[lo] += from_prev
            if from_next is not None:
                y3[hi] += from_next
        return y3.reshape(-1)


def _check_sensors_outside_band(dec, pts):
    """The closed-form sensor location assumes the uniform lattice's nodes;
    inside the blend band of a bowl-fitted mesh they are deformed, so a
    sensor there would be silently displaced: refuse it."""
    if not dec.band_layers:
        return
    band_x = dec.lo[0] + dec.band_layers * dec.h[0]
    if np.any(pts[0] < band_x - 1e-12):
        raise ValueError(
            f"sharded hybrid recording: sensor(s) at x < {band_x:.6g} fall inside the "
            "deformed blend band, where the uniform-lattice snap is wrong; move them "
            "beyond the band or record on a single device")


def lattice_interp_nodes(dec, points):
    """Closed-form interpolating sensor tables on the uniform lattice of a
    slab decomposition: the global GLL node coordinates [dim, n, K] of each
    sensor's cell (K = (p+1)^dim) and its Lagrange weights [n, K]; a sensor
    on a node has a one-hot row. Needs no global mesh (the streamed path)."""
    pts = np.asarray(points, np.float64)
    _check_sensors_outside_band(dec, pts)
    p = dec.degree
    d = len(dec.grid)
    n = pts.shape[1]
    axes_nodes, axes_w = [], []
    for a in range(d):
        h = (dec.hi[a] - dec.lo[a]) / dec.grid[a]
        s = (pts[a] - dec.lo[a]) / h
        cell = np.clip(np.floor(s).astype(np.int64), 0, dec.grid[a] - 1)
        xi = np.clip(s - cell, 0.0, 1.0)
        axes_nodes.append(cell[:, None] * p + np.arange(p + 1)[None, :])
        axes_w.append(lagrange_eval_gll(p + 1, xi))
    sub = np.indices((p + 1,) * d).reshape(d, -1)  # [d, K], axis 0 slowest
    coords = np.stack([axes_nodes[a][:, sub[a]] for a in range(d)])
    w = axes_w[0]
    for a in range(1, d):
        w = (w[:, :, None] * axes_w[a][:, None, :]).reshape(n, -1)
    return coords, w


def collapse_onehot(coords, wts, tol=1e-9):
    """(virtual-sensor node coordinates, weights or None): sensors that all
    sit on lattice nodes collapse to their node; otherwise every sensor
    expands into its cell's K nodes, summed back with its weights on the
    host (``weighted_sensor_rows``). A replicated interface node is the same
    on either holder, so ownership per node suffices."""
    d, n, K = coords.shape
    amax = np.abs(wts).max(axis=1)
    if np.all(amax >= 1.0 - tol):
        k = np.abs(wts).argmax(axis=1)
        return coords[:, np.arange(n), k], None
    return coords.reshape(d, n * K), wts


def weighted_sensor_rows(vals, wts):
    """Host reassembly: [steps, n*K] virtual-sensor rows → [steps, n]
    interpolated sensor values (the identity when ``wts`` is None)."""
    if wts is None:
        return vals
    n, K = wts.shape
    return (vals.reshape(vals.shape[0], n, K) * wts).sum(axis=-1)


class _Decomposition:
    """What every decomposition shares: this rank's part of a model's
    consts. A subclass gives ``to_local`` (a global DOF vector → this
    rank's), ``_local_cells`` (a global [Nc] cell array → this rank's cells,
    host float64), ``_pack_stiff_coeff`` and ``_pack_nodal_coeff``."""

    def shard_consts(self, consts: dict, global_ndofs: int, global_ncells: int, stiff_keys=(),
                     raw_stiff=None, nodal_stiff_keys=(), raw_nodal=None, pad_one=()):
        """This rank's part of a model's consts: DOF vectors → its DOFs,
        cell vectors → its cells, scalars as they are. Keys in
        ``stiff_keys`` (DG-0 stiffness coefficients) and ``nodal_stiff_keys``
        (per-DOF coefficients, the sponge's δ) are packed here from the raw
        float64 values (``raw_stiff``/``raw_nodal``) into the local operators'
        format (K1's ``pack_const``/``pack_field`` on a 3D lattice, the
        lattice scales in 1D/2D, the hybrid dict on rank 0 of a bowl, a
        per-cell tensor on the general path). Keys in ``pad_one`` pad with
        1.0 (diagonals the solver divides by), the others with 0. The fused
        step's packed consts are left out."""
        raw_stiff, raw_nodal = raw_stiff or {}, raw_nodal or {}
        out = {}
        for k, val in consts.items():
            if k.endswith(FUSED_STEP_SUFFIXES):
                continue
            if k in stiff_keys:
                if k not in raw_stiff:
                    raise ValueError(f"stiffness const {k!r} has no raw value in model.raw_stiff")
                coeff = np.broadcast_to(np.asarray(raw_stiff[k], np.float64).reshape(-1),
                                        (global_ncells,))
                out[k] = self._pack_stiff_coeff(coeff)
                continue
            if k in nodal_stiff_keys:
                if k not in raw_nodal:
                    raise ValueError(f"nodal const {k!r} has no raw value in model.raw_nodal")
                out[k] = self._pack_nodal_coeff(raw_nodal[k])
                continue
            if isinstance(val, (int, float)) or getattr(val, "ndim", None) == 0:
                out[k] = val
            elif isinstance(val, (tuple, list, dict)):
                raise ValueError(
                    f"const {k!r} is a packed/structured value; declare it in the model's "
                    "STIFF_KEYS (DG-0 coefficients, raw values in model.raw_stiff) or "
                    "NODAL_STIFF_KEYS (per-DOF coefficients, raw values in model.raw_nodal) "
                    "so the sharded solver can pack it per rank")
            elif tuple(val.shape) == (global_ndofs,):
                out[k] = self.to_local(val, pad_value=1.0 if k in pad_one else 0.0)
            elif tuple(val.shape) == (global_ncells,):
                cells = val.cpu().numpy() if isinstance(val, torch.Tensor) else val
                out[k] = torch.as_tensor(self._local_cells(cells), dtype=self.dtype,
                                         device=self.device)
            else:
                raise ValueError(f"const {k}: unexpected shape {tuple(val.shape)}")
        return out


class GridDecomposition(_Decomposition):
    """Block partition of a uniform structured mesh over a (d0[, d1[, d2]])
    grid of the default process group's ranks (the leading mesh axes), as
    seen from this rank: its local operators, its block of a global DOF
    vector, its coefficients and its replica/padding dot weights. Rank r
    holds block ``np.unravel_index(r, dshape)`` (row-major, the order in
    which the JAX package stacks its devices' blocks); the slab is the grid
    of one axis.

    Every rank holds the same local lattice ``local_gdims`` (the first
    block's: the lattice is uniform, only coefficients and diagonals
    differ), sensors snap to the global GLL lattice in closed form, and DG-0
    coefficients pack through the local operators. Cell counts need not
    divide the grid: each axis is padded with inert cells."""

    band_layers = 0

    def __init__(self, mesh: Mesh, degree: int, dshape, dtype=torch.float32, device="cuda"):
        device = resolve_device(device)
        if mesh.grid_shape is None:
            raise ValueError("grid decomposition needs a structured mesh")
        if mesh.uniform_hint is False:
            # a deformed (e.g. bowl-fitted) lattice: the blocks assume uniform
            # geometry everywhere, so sharding it would drop the deformation
            raise ValueError(
                "grid decomposition requires a uniform lattice; this mesh is deformed "
                "(uniform_hint=False): shard it with as_unstructured(mesh) + "
                "ShardedUnstructuredExplicitSolver, or run on one device (hybrid fast path)")
        self._setup(mesh.grid_shape, mesh.vertices.min(axis=0), mesh.vertices.max(axis=0),
                    degree, dshape, dtype, device)

    @classmethod
    def from_grid(cls, grid, lo, hi, degree: int, dshape, dtype, device="cuda"):
        """Construction without a mesh (the streamed setup: host memory
        O(local))."""
        self = object.__new__(cls)
        self._setup(tuple(grid), np.asarray(lo, float), np.asarray(hi, float), degree, dshape,
                    dtype, resolve_device(device))
        return self

    def _setup(self, n, lo, hi, degree: int, dshape, dtype, device):
        """``dshape``: the blocks along each partitioned axis; an int or
        None is one axis (None: as many blocks as ranks)."""
        if dshape is not None and np.ndim(dshape) > 0 and len(dshape) > len(n):
            raise ValueError("more device-mesh axes than mesh axes")
        self.exchange = _Exchange()
        world, rank = self.exchange.world, self.exchange.rank
        if dshape is None or np.ndim(dshape) == 0:
            dshape = (world if dshape is None else dshape,)
        dshape = tuple(int(a) for a in dshape)
        na = len(dshape)
        if int(np.prod(dshape)) != world:
            raise ValueError(f"dshape {dshape} holds {int(np.prod(dshape))} blocks, but the "
                             f"process group has {world} ranks (one rank holds one block)")
        self.na, self.dshape = na, dshape
        self.ndev, self.rank = world, rank
        self.didx = tuple(int(i) for i in np.unravel_index(rank, dshape))
        self.dtype, self.device = dtype, device
        self.grid = tuple(n)
        self.degree = p = degree
        self.lo, self.hi = np.asarray(lo, float), np.asarray(hi, float)
        self.nxl = [-(-n[a] // dshape[a]) for a in range(na)]
        self.gdims = tuple(nn * p + 1 for nn in n)
        self.Ls = tuple(self.nxl[a] * p + 1 for a in range(na))
        self.Gs = self.gdims[:na]
        self.rest = int(np.prod(self.gdims[na:])) if len(n) > na else 1
        self.cells_rest = int(np.prod(n[na:])) if len(n) > na else 1
        self.cells_per_dev = int(np.prod(self.nxl)) * self.cells_rest
        self.local_gdims = self.Ls + self.gdims[na:]
        self.h = [(self.hi[a] - self.lo[a]) / n[a] for a in range(na)]
        hi_l = self.hi.copy()
        for a in range(na):
            hi_l[a] = self.lo[a] + self.nxl[a] * self.h[a]
        # the local mesh is the first block (a uniform lattice: the same
        # operators on every rank)
        self.local_mesh = _structured(tuple(self.nxl) + tuple(n[na:]), tuple(self.lo),
                                      tuple(hi_l))
        self._make_ops(self.local_mesh)

    def _make_ops(self, local_mesh):
        self.ops = HaloSEMOperators(local_mesh, self.degree, self.dtype, self.device)
        self.ops.configure_halo(self.exchange, self.dshape, self.Ls, self.rest)
        self.local_ndofs = self.ops.ndofs
        assert self.local_ndofs == int(np.prod(self.Ls)) * self.rest

    # ---- global <-> local DOF vectors -------------------------------------

    def _starts(self, didx=None):
        """The first global lattice row of block ``didx`` (default: this
        rank's) along each partitioned axis."""
        didx = self.didx if didx is None else didx
        return [didx[a] * (self.Ls[a] - 1) for a in range(self.na)]

    def to_local(self, vec, pad_value: float = 0.0, dtype=None, device=None) -> torch.Tensor:
        """This rank's block [local_ndofs] of a global DOF vector ``vec``
        (array or tensor, [ndofs]): its rows of every partitioned axis
        including both interface planes, rows past the mesh set to
        ``pad_value``; in the operators' dtype on this rank's device unless
        ``dtype``/``device`` say otherwise."""
        dtype, device = dtype or self.dtype, device or self.device
        t = torch.as_tensor(vec).reshape(self.Gs + (self.rest,))
        part = t[tuple(slice(s, s + L) for s, L in zip(self._starts(), self.Ls))]
        out = torch.full(self.Ls + (self.rest,), pad_value, dtype=dtype, device=device)
        out[tuple(slice(0, k) for k in part.shape[: self.na])] = part.to(device=device,
                                                                        dtype=dtype)
        return out.reshape(-1)

    def gather_global(self, local: torch.Tensor) -> torch.Tensor:
        """The global vector [ndofs] from every rank's block, on every rank
        (a collective): replicated planes written once, padding dropped."""
        s = self.exchange.all_gather(local).reshape((self.ndev,) + self.Ls + (self.rest,))
        padded = tuple(self.nxl[a] * self.dshape[a] * self.degree + 1 for a in range(self.na))
        full = s.new_zeros(padded + (self.rest,))
        for r, didx in enumerate(np.ndindex(*self.dshape)):
            starts = self._starts(didx)
            full[tuple(slice(b, b + L) for b, L in zip(starts, self.Ls))] = s[r]
        return full[tuple(slice(0, g) for g in self.Gs)].reshape(-1)

    def locate_sensors(self, points):
        """Snap sensor ``points`` [dim, n] to the global GLL lattice: (the
        rank holding each [n], its local lattice coordinates [dim, n], the
        partitioned axes in local coordinates). Closed form (grid and GLL
        nodes), no mesh needed."""
        pts = np.asarray(points, np.float64)
        _check_sensors_outside_band(self, pts)
        p = self.degree
        gll, _ = gll_points_weights_01(p + 1)
        coords = []
        for a in range(len(self.grid)):
            h = (self.hi[a] - self.lo[a]) / self.grid[a]
            xi = (pts[a] - self.lo[a]) / h
            cell = np.clip(np.floor(xi).astype(np.int64), 0, self.grid[a] - 1)
            loc = np.clip(xi - cell, 0.0, 1.0)
            node = np.argmin(np.abs(loc[:, None] - gll[None, :]), axis=1)
            coords.append(cell * p + node)
        return self._nodes_to_dev_loc(np.stack(coords))

    def sensor_slots(self, points):
        """(holding rank [m], index into the holder's local DOF vector [m],
        weights [n, K] or None) of the virtual sensors of ``points`` [dim,
        n]: node-aligned sensors read their node, off-node ones the K nodes
        of their cell, summed back with the weights (``collapse_onehot``)."""
        coords, wts = lattice_interp_nodes(self, points)
        nodes, wts = collapse_onehot(coords, wts)
        dev, loc = self._nodes_to_dev_loc(nodes)
        return dev, np.ravel_multi_index(tuple(loc), self.local_gdims), wts

    def _nodes_to_dev_loc(self, coords):
        """Global lattice node coordinates [dim, m] → (holding rank [m],
        local coordinates [dim, m]); a replicated interface node goes to
        the upper block along each partitioned axis (the replicas are
        identical)."""
        dev_coords, loc = [], []
        for a in range(self.na):
            da = np.minimum(coords[a] // (self.Ls[a] - 1), self.dshape[a] - 1)
            dev_coords.append(da)
            loc.append(coords[a] - da * (self.Ls[a] - 1))
        dev = np.ravel_multi_index(tuple(dev_coords), self.dshape)
        return dev, np.stack(loc + [coords[a] for a in range(self.na, len(coords))])

    def dot_weights(self) -> torch.Tensor:
        """This rank's DOF weights [local_ndofs] making the sum over ranks of
        Σ_i w·a·b the global inner product: 1/(replica count), that is 1/2
        on each shared plane, multiplied at edges and corners, and 0 on
        padding rows."""
        w = np.ones(self.Ls + (self.rest,))
        for a, s in enumerate(self._starts()):
            lo = (slice(None),) * a + (0,)
            hi = (slice(None),) * a + (-1,)
            if self.didx[a] > 0:
                w[lo] *= 0.5
            if self.didx[a] < self.dshape[a] - 1:
                w[hi] *= 0.5
            w[(slice(None),) * a + (slice(max(self.Gs[a] - s, 0), None),)] = 0.0
        return torch.as_tensor(w.reshape(-1), dtype=self.dtype, device=self.device)

    # ---- coefficients ------------------------------------------------------

    def _true_cells(self, didx=None):
        """Per partitioned axis, how many of block ``didx``'s cells lie in
        the mesh (0 for a block of padding only)."""
        didx = self.didx if didx is None else didx
        return [max(min((didx[a] + 1) * self.nxl[a], self.grid[a]) - didx[a] * self.nxl[a], 0)
                for a in range(self.na)]

    def _local_cells(self, arr_cells) -> np.ndarray:
        """This rank's [cells_per_dev] of a global [Nc] cell array (padding
        cells 0)."""
        na = self.na
        a = np.asarray(arr_cells, np.float64).reshape(tuple(self.grid[:na]) + (self.cells_rest,))
        part = a[tuple(slice(self.didx[x] * self.nxl[x], (self.didx[x] + 1) * self.nxl[x])
                       for x in range(na))]
        out = np.zeros(tuple(self.nxl) + (self.cells_rest,))
        out[tuple(slice(0, k) for k in part.shape[:na])] = part
        return out.reshape(-1)

    def _pack_stiff_coeff(self, coeff):
        """This rank's packed DG-0 stiffness coefficient from the global
        [Nc] one: its cells (padding 0, so padding cells add nothing) in the
        local operators' format. The fold is over local cells only; the halo
        exchange completes the interface planes at run time."""
        return self.ops.stiff_coeff(self._local_cells(coeff))

    def _pack_nodal_coeff(self, nodal):
        """This rank's packed nodal stiffness coefficient (the sponge's δ):
        its block of the global field, packed by ``_nodal_scales`` (padding
        cells 0). δ is pointwise, so the replicated planes carry equal values
        and need no interface sum."""
        block = self.to_local(np.asarray(nodal, np.float64), dtype=torch.float64, device="cpu")
        return self._nodal_scales(block.numpy(), self._true_cells())

    def _nodal_scales(self, block: np.ndarray, true_cells) -> tuple:
        """The local lattice's scales (``pack_scales_nodal``) of a nodal
        coefficient ``block`` (this rank's lattice rows, float64) when only
        the first ``true_cells[a]`` cells along each partitioned axis lie in
        the mesh: the scales of that true sub-lattice, zero on the padding
        cells. Zero nodal values on the padding rows are not enough: a
        padding cell shares a face with the last true cells, and the
        coefficient there would weigh the padding cell's stiffness."""
        lat = self.ops.lattice
        if lat is None:
            raise ValueError("nodal stiffness coefficients need the lattice path")
        na = len(true_cells)
        if tuple(true_cells) == lat.grid[:na]:
            return self.ops.pack_scales_nodal(block)
        shapes = [tuple(g * lat.N if b == a else lat.gdims[b] for b, g in enumerate(lat.grid))
                  for a in range(lat.d)]
        out = [np.zeros(shape) for shape in shapes]
        if min(true_cells) > 0:
            sub = LatticeStiffness(tuple(true_cells) + lat.grid[na:], lat.p, lat.h)
            rows = tuple(slice(0, t * lat.p + 1) for t in true_cells)
            for full, part in zip(out, sub.scales_nodal(block.reshape(lat.gdims)[rows])):
                full[tuple(slice(0, k) for k in part.shape)] = part
        return tuple(self.ops.to_device(t) for t in out)


class SlabDecomposition(GridDecomposition):
    """The grid of one axis over every rank, ``dshape = (world,)``, that
    also takes a bowl-fitted mesh: its blend band must fit inside rank 0's
    slab, whose operators are then hybrid (``_hybridize``)."""

    def __init__(self, mesh: Mesh, degree: int, ndev=None, dtype=torch.float32, device="cuda"):
        device = resolve_device(device)
        if mesh.grid_shape is None:
            raise ValueError("slab decomposition needs a structured mesh")
        bowl = False
        if mesh.uniform_hint is False:
            if (mesh.dim == 3 and mesh.blend_layers and mesh.uniform_box is not None
                    and os.environ.get("FUS_HYBRID", "") != "0"):
                bowl = True  # deformed only in its first blend_layers x-layers
            else:
                raise ValueError(
                    "slab decomposition requires a uniform lattice or a bowl-fitted one "
                    "(blend_layers + uniform_box set); this mesh is generally deformed: "
                    "run it on one device")
        if bowl:
            # the cap dips behind the box: the slab geometry is the uniform box's
            lo, hi = (np.asarray(a, float) for a in mesh.uniform_box)
        else:
            lo, hi = mesh.vertices.min(axis=0), mesh.vertices.max(axis=0)
        self._setup(mesh.grid_shape, lo, hi, degree, ndev, dtype, device)
        if bowl:
            self._hybridize(mesh)

    def _hybridize(self, mesh):
        """Bowl-fitted lattice: all deformation lies in the first
        ``blend_layers`` x-layers of cells, which must fit inside rank 0's
        slab. Rank 0's local operators become hybrid (its slab's true
        vertices, the uniform box as its lattice); the other ranks keep the
        uniform lattice."""
        n, nxl = self.grid, self.nxl[0]
        bx = int(mesh.blend_layers)
        if bx > nxl:
            raise ValueError(
                f"hybrid slab sharding needs the blend band (blend_layers={bx} x-layers) "
                f"inside rank 0's slab ({nxl} layers); use <= {max(1, n[0] // bx)} "
                "ranks or run on one device")
        self.band_layers = bx
        if self.rank != 0:
            return
        gv = mesh.vertices.reshape(tuple(na + 1 for na in n) + (3,))
        local = self.local_mesh
        self.local_mesh = Mesh(dim=3, vertices=gv[: nxl + 1].reshape(-1, 3),
                               cells=local.cells, grid_shape=local.grid_shape,
                               uniform_hint=False, blend_layers=bx,
                               uniform_box=(self.lo.copy(), local.vertices.max(axis=0)))
        self._make_ops(self.local_mesh)
        if self.ops.hybrid is None:
            raise RuntimeError("rank 0's hybrid local operators failed to build")


def _model_shard_kwargs(model):
    cls = type(model)
    return dict(stiff_keys=getattr(cls, "STIFF_KEYS", ()),
                raw_stiff=getattr(model, "raw_stiff", None),
                nodal_stiff_keys=getattr(cls, "NODAL_STIFF_KEYS", ()),
                raw_nodal=getattr(model, "raw_nodal", None),
                pad_one=getattr(cls, "PAD_ONE_KEYS", ()))


def _check_streamed_initial_zero(model):
    """The streamed setup never builds global fields, so its solver starts
    from zero fields (as every reference driver does); a nonzero
    ``model.u_n``/``v_n`` of the rank's template model cannot be honoured:
    raise instead of dropping it."""
    for name in ("u_n", "v_n"):
        arr = getattr(model, name, None)
        if arr is not None and bool(torch.any(torch.as_tensor(arr) != 0)):
            raise ValueError(
                f"streamed-setup solver starts from zero fields, but the template model has "
                f"nonzero {name}; set the state through the solver's local fields "
                "(solver._u_loc/_v_loc, [local_ndofs] each) or use the non-streamed solver")


class _ShardedSolver:
    """What the explicit and the implicit sharded solvers of every
    decomposition share: the local state, its gather, the march and the
    sensor recording. ``_make_dec(model, where, device)`` builds the
    decomposition (``where``: the slab's ``ndev``, the grid's ``dshape``)."""

    _streamed = False

    @staticmethod
    def _make_dec(model, ndev, device):
        return SlabDecomposition(model.mesh, model.degree, ndev, model.dtype, device)

    def _setup(self, model, where, device, pad_one=()):
        self.model = model
        self.dec = self._make_dec(model, where, resolve_device(device))
        kw = _model_shard_kwargs(model)
        kw["pad_one"] = tuple(kw["pad_one"]) or pad_one
        self.consts = self.dec.shard_consts(model.consts, model.ops.ndofs, model.mesh.num_cells,
                                            **kw)

    def _initial_local(self):
        """This rank's (u, v): its slab of the model's global state, or on
        the streamed path (no global vector) zeros carried across calls."""
        if self._streamed:
            if not hasattr(self, "_u_loc"):
                _check_streamed_initial_zero(self.model)
                z = torch.zeros(self.dec.local_ndofs, dtype=self.model.dtype,
                                device=self.dec.device)
                self._u_loc, self._v_loc = z, z.clone()
            return self._u_loc, self._v_loc
        return self.dec.to_local(self.model.u_n), self.dec.to_local(self.model.v_n)

    def _store_local(self, u, v, t):
        model = self.model
        model.t = t
        if self._streamed:
            self._u_loc, self._v_loc = u, v
            return u, v, t
        model.u_n, model.v_n = self.dec.gather_global(u), self.dec.gather_global(v)
        return model.u_n, model.v_n, t

    def global_result(self):
        """The global (u, v) on every rank (a collective; for analysis at
        sizes where that fits)."""
        return self.dec.gather_global(self._u_loc), self.dec.gather_global(self._v_loc)

    def _march(self, step, t0, tf, record=None):
        """Run ``step`` over ``step_sizes(t0, tf, dt)`` from this rank's
        state, each step from its float64 host start time; (u, v, dts)."""
        u, v = self._initial_local()
        dts = step_sizes(t0, tf, self.model.dt)
        u, v, _ = run_steps(step, self.consts, u, v, t0, dts, record=record)
        return u, v, dts

    def _sensor_slots(self, points):
        """(holding rank, index into the holder's local vector, weights or
        None) of each virtual sensor of ``points``."""
        return self.dec.sensor_slots(points)

    def _sensor_plan(self, points):
        """This rank's extractor of its sensors' nodes (padded to the most
        any rank holds) and the host reassembly map (rank, slot, weights):
        node-aligned sensors read their node, off-node ones interpolate
        through virtual nodes (``collapse_onehot``)."""
        dec = self.dec
        dev, flat, wts = self._sensor_slots(points)
        counts = np.bincount(dev, minlength=dec.ndev)
        slot = np.zeros(dev.size, np.int64)
        for r in range(dec.ndev):
            slot[dev == r] = np.arange(counts[r])
        mine = dev == dec.rank
        idx = np.zeros(max(int(counts.max()), 1), np.int64)
        idx[: int(mine.sum())] = flat[mine]
        if dec.local_ndofs == 0:  # a rank of the unstructured split with no cells
            return (lambda u: u.new_zeros(idx.size)), dev, slot, wts
        it = torch.as_tensor(idx, device=dec.device)
        return (lambda u: u.reshape(-1).index_select(0, it)), dev, slot, wts

    def _recorded(self, step, t0, tf, points):
        """``_march`` recording this rank's sensor nodes after every step;
        (u, v, dts, ys [steps, n]), ys reassembled from every rank's nodes
        (a collective)."""
        extract, dev, slot, wts = self._sensor_plan(points)
        rows = []
        u, v, dts = self._march(step, t0, tf, record=lambda i, u: rows.append(extract(u)))
        vals = self.dec.exchange.all_gather(torch.stack(rows)).double().cpu().numpy()
        ys = weighted_sensor_rows(vals[dev, :, slot].T, wts)
        return u, v, dts, torch.as_tensor(ys, dtype=self.model.dtype, device=self.dec.device)


class ShardedExplicitSolver(_ShardedSolver):
    """Run an explicit model's unfused step over the ranks, one slab each.

    Usage, on every rank::

        model = LinearSpectralExplicit(mesh, ..., device=device)   # global setup
        sharded = ShardedExplicitSolver(model, device=device)
        u, v, t = sharded.rk(t0, tf)                                # == model.rk(t0, tf)
    """

    def __init__(self, model, ndev=None, device="cuda"):
        resolve_device(device)
        if not hasattr(type(model), "rhs_pure"):
            raise ValueError(f"{type(model).__name__} has no rhs_pure to shard")
        self._setup(model, ndev, device)

    def _step(self):
        return self.model.unfused_step(ops=self.dec.ops)

    def rk(self, t0: float, tf: float):
        u, v, dts = self._march(self._step(), t0, tf)
        return self._store_local(u, v, t0 + float(np.sum(dts)))

    def rk_record(self, t0: float, tf: float, points):
        """``rk`` while recording u at sensor ``points`` [dim, n] after every
        step, each rank its own nodes on its device (the reference's
        distributed point evaluation, ``cpp/mwe/parallel_eval_line/main.cpp:
        49-107``). Returns (u, v, t, times [steps] float64, ys [steps, n]),
        the series of the single-device ``model.rk_record``."""
        u, v, dts, ys = self._recorded(self._step(), t0, tf, points)
        u, v, t = self._store_local(u, v, t0 + float(np.sum(dts)))
        return u, v, t, t0 + np.cumsum(dts), ys


class ShardedImplicitSolver(_ShardedSolver):
    """Run an implicit (SDIRK) model over the ranks: each rank's CG applies
    its local ``lhs_pure`` (K1 on the card, completed by the halo
    exchange) and reduces its interface-weighted dots over the ranks (the
    reference's per-iteration MPI allreduce, ``_linear.py:644-647``). The
    iterates are the single device's in exact arithmetic; ``dirk`` sets the
    model's ``cg_stats`` as ``model.dirk`` does.

    Usage, on every rank::

        model = LinearSpectralImplicit(mesh, ..., device=device)   # global setup
        sharded = ShardedImplicitSolver(model, device=device)
        u, v, t = sharded.dirk(t0, tf)                              # == model.dirk(t0, tf)
    """

    def __init__(self, model, ndev=None, device="cuda"):
        self._setup(model, ndev, device, pad_one=("m",))
        self.weights = self.dec.dot_weights()

    def _dot(self, x, y):
        return self.dec.exchange.allreduce_sum(torch.sum(self.weights * x * y))

    def _dirk_step(self, stats):
        return self.model.dirk_step(ops=self.dec.ops, stats=stats, dot=self._dot)

    def _set_cg_stats(self, stats):
        self.model.cg_stats = {"max_iterations": max(it for it, _ in stats),
                               "max_residual2": float(torch.stack([r for _, r in stats]).max())}

    def dirk(self, t0: float, tf: float):
        stats = []
        u, v, dts = self._march(self._dirk_step(stats), t0, tf)
        self._set_cg_stats(stats)
        return self._store_local(u, v, t0 + float(np.sum(dts)))

    def dirk_record(self, t0: float, tf: float, points):
        """``dirk`` while recording u at sensor ``points`` after every step
        (the implicit counterpart of ``rk_record``)."""
        stats = []
        u, v, dts, ys = self._recorded(self._dirk_step(stats), t0, tf, points)
        self._set_cg_stats(stats)
        u, v, t = self._store_local(u, v, t0 + float(np.sum(dts)))
        return u, v, t, t0 + np.cumsum(dts), ys


# ---------------------------------------------------------------------------
# Streamed setup: each rank builds its own slab, no global DOF vector


def _host64(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        return val.detach().double().cpu().numpy()
    return np.asarray(val, np.float64)


def build_streamed(dec: GridDecomposition, model_factory, implicit: bool, solver_cls):
    """A ``solver_cls`` on ``dec`` whose host memory is O(ndofs / ranks):
    each rank builds the model on its own block only (the reference's
    "every MPI rank constructs its partition",
    ``cpp/fenicsx-sf/.../main.cpp:56-63``). The common body of
    ``build_sharded`` (the slab) and ``grid.build_sharded_grid``.

    ``model_factory(local_mesh) -> model`` builds the model on a block mesh
    positioned in space: tag boundaries with position predicates (the
    interface planes must match none) and take DG-0 coefficients from
    ``local_mesh.cell_midpoints()``. A block that holds fewer cells gets a
    smaller mesh and inert padding; a block with no cells builds its
    template on the first block and keeps none of its data.

    Models declare ``SHARD_INV_KEYS`` for consts stored as reciprocals of
    assembled diagonals (``inv_m``); every other [ndofs] const is taken as
    additively assembled, and its shared planes are summed with the
    neighbours' in float64 through the per-axis exchange of ``complete``
    (the setup data's ``scatter_rev(+)``). Nodal stiffness coefficients
    (the sponge's δ) are pointwise and ship without an exchange. The solver
    starts from zero fields; ``rk``/``dirk`` keep the local state and
    ``global_result()`` gathers it."""
    na, p, n = dec.na, dec.degree, dec.grid
    local_shape = dec.Ls + (dec.rest,)
    if min(dec._true_cells(tuple(0 for _ in range(na)))) == 0:
        raise ValueError("first block has no cells — reduce dshape")
    tc = dec._true_cells()
    empty = min(tc) == 0
    blk = tuple(0 for _ in range(na)) if empty else dec.didx
    tc_m = dec._true_cells(blk)
    l0, h0 = dec.lo.copy(), dec.hi.copy()
    for a in range(na):
        l0[a] = dec.lo[a] + blk[a] * dec.nxl[a] * dec.h[a]
        h0[a] = l0[a] + tc_m[a] * dec.h[a]
    model = model_factory(_structured(tuple(tc_m) + tuple(n[na:]), tuple(l0), tuple(h0)))
    cls = type(model)
    inv_keys = tuple(getattr(cls, "SHARD_INV_KEYS", ()))
    pad_one = tuple(getattr(cls, "PAD_ONE_KEYS", ())) or (("m",) if implicit else ())
    stiff_keys = tuple(getattr(cls, "STIFF_KEYS", ()))
    nodal_keys = tuple(getattr(cls, "NODAL_STIFF_KEYS", ()))
    true_rows = [t * p + 1 if t > 0 else 0 for t in tc]
    inside = tuple(slice(0, r) for r in true_rows)
    # rows past the mesh; a block of padding only may still start on its last plane
    pad_from = [min(max(g - s, 0), L) for g, s, L in zip(dec.Gs, dec._starts(), dec.Ls)]

    def embed(arr, cells: bool = False):
        """A local array of this block's true extent in the padded box."""
        if cells:
            full = np.zeros(tuple(dec.nxl) + (dec.cells_rest,))
            full[tuple(slice(0, t) for t in tc)] = arr.reshape(tuple(tc) + (dec.cells_rest,))
            return full
        full = np.zeros(local_shape)
        full[inside] = arr.reshape(tuple(true_rows) + (dec.rest,))
        return full

    consts, raw = {}, {}
    for k, val in model.consts.items():
        if k.endswith(FUSED_STEP_SUFFIXES):
            continue
        if k in stiff_keys:
            full = np.zeros(dec.cells_per_dev)
            if not empty:
                coeff = np.broadcast_to(np.asarray(model.raw_stiff[k], np.float64).reshape(-1),
                                        (int(np.prod(tc)) * dec.cells_rest,))
                full = embed(coeff, cells=True).reshape(-1)
            consts[k] = dec.ops.stiff_coeff(full)
        elif k in nodal_keys:
            full = np.zeros(local_shape) if empty else embed(
                np.asarray(model.raw_nodal[k], np.float64))
            consts[k] = dec._nodal_scales(full, tc)
        elif isinstance(val, (int, float)) or getattr(val, "ndim", None) == 0:
            consts[k] = val
        else:
            arr = _host64(val)
            if arr.size != model.ops.ndofs:
                raise ValueError(f"const {k}: shape {arr.shape} not a dof vector; declare "
                                 "STIFF_KEYS/NODAL_STIFF_KEYS")
            full = np.zeros(local_shape)
            if not empty:
                if k in inv_keys:  # back to the assembled diagonal
                    arr = np.where(arr != 0.0, 1.0 / np.where(arr == 0.0, 1.0, arr), 0.0)
                full = embed(arr)
            raw[k] = full
    for k, full in raw.items():
        # the shared planes, edges and corners: add the neighbours' partial sums
        a = dec.ops.complete(torch.as_tensor(full.reshape(-1), dtype=torch.float64,
                                             device=dec.device)).reshape(local_shape)
        if k in inv_keys:
            a = torch.where(a != 0.0, 1.0 / torch.where(a == 0.0, 1.0, a), 0.0)
        if k in pad_one:
            for ax, (start, L) in enumerate(zip(pad_from, dec.Ls)):
                if start < L:
                    a[(slice(None),) * ax + (slice(start, None),)] = 1.0
        consts[k] = a.reshape(-1).to(dec.dtype)

    solver = object.__new__(solver_cls)
    solver.model, solver.dec, solver.consts = model, dec, consts
    solver._streamed = True
    if implicit:
        solver.weights = dec.dot_weights()
    return solver


def build_sharded(model_factory, grid, lo, hi, degree, ndev, dtype, implicit: bool = False,
                  device="cuda"):
    """A slab-sharded solver built by ``build_streamed``: each rank builds
    the model on its own slab only (interface x-planes must match none of
    the factory's boundary predicates)."""
    dec = SlabDecomposition.from_grid(grid, lo, hi, degree, ndev, dtype, device)
    return build_streamed(dec, model_factory, implicit,
                          ShardedImplicitSolver if implicit else ShardedExplicitSolver)
