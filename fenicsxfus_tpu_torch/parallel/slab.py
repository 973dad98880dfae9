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

    def neighbours(self, first: torch.Tensor, last: torch.Tensor):
        """(the left neighbour's last plane, the right neighbour's first
        plane), None at the ends: this rank's ``first`` plane goes left and
        its ``last`` right."""
        host = self._host(first)
        ops, recv = [], {}
        for side, peer, plane in (("left", self.rank - 1, first),
                                  ("right", self.rank + 1, last)):
            if 0 <= peer < self.world:
                buf = plane.cpu() if host else plane.contiguous()
                recv[side] = torch.empty_like(buf)
                ops += [dist.P2POp(dist.isend, buf, peer), dist.P2POp(dist.irecv, recv[side], peer)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        back = (lambda t: t.to(first.device)) if host else (lambda t: t)  # noqa: E731
        return (back(recv["left"]) if "left" in recv else None,
                back(recv["right"]) if "right" in recv else None)

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
    """SEMOperators on the local slab whose assembly hook ``complete`` adds
    the neighbours' interface-plane partial sums (the JAX package's
    ``ppermute`` exchange). The identity at world size 1."""

    def configure_halo(self, exchange: _Exchange, plane_rows: int, row_size: int):
        self._exchange = exchange
        self._plane_rows = plane_rows  # local lattice rows along axis 0
        self._row_size = row_size  # DOFs per lattice plane

    def complete(self, y):
        ex = self._exchange
        if ex.world == 1:
            return y
        y2 = y.reshape(self._plane_rows, self._row_size)
        from_left, from_right = ex.neighbours(y2[0], y2[-1])
        if from_left is not None:
            y2[0] += from_left
        if from_right is not None:
            y2[-1] += from_right
        return y2.reshape(-1)


def _check_sensors_outside_band(dec, pts):
    """The closed-form sensor location assumes the uniform lattice's nodes;
    inside the blend band of a bowl-fitted mesh they are deformed, so a
    sensor there would be silently displaced: refuse it."""
    if not dec.band_layers:
        return
    band_x = dec.lo[0] + dec.band_layers * dec.hx
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


class SlabDecomposition:
    """Slab partition of a uniform (or bowl-fitted) structured mesh over the
    ranks of the default process group, as seen from this rank: its local
    operators, its slab of a global DOF vector, its coefficients and its
    interface/padding dot weights."""

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

    @classmethod
    def from_grid(cls, grid, lo, hi, degree: int, ndev, dtype, device="cuda"):
        """Construction without a mesh (the streamed setup: host memory
        O(local))."""
        self = object.__new__(cls)
        self._setup(tuple(grid), np.asarray(lo, float), np.asarray(hi, float), degree, ndev,
                    dtype, resolve_device(device))
        return self

    def _setup(self, n, lo, hi, degree: int, ndev, dtype, device):
        self.exchange = _Exchange()
        world, rank = self.exchange.world, self.exchange.rank
        if ndev is not None and ndev != world:
            raise ValueError(f"ndev={ndev}, but the process group has {world} ranks "
                             "(one rank holds one slab)")
        d = len(n)
        self.grid = tuple(n)
        self.lo = np.asarray(lo, float)
        self.hi = np.asarray(hi, float)
        self.degree = degree
        self.ndev, self.rank = world, rank
        self.dtype, self.device = dtype, device
        p = degree
        # uneven partitions: pad axis 0 to a multiple of the world size with
        # inert cells (every rank then holds the same local lattice)
        nxl = -(-n[0] // world)
        self.nxl = nxl
        self.pad_cells = nxl * world - n[0]
        self.gdims = tuple(na * p + 1 for na in n)
        self.G0 = self.gdims[0]  # true lattice rows along axis 0
        self.Lx = nxl * p + 1  # local lattice rows (both interfaces included)
        self.row_size = int(np.prod(self.gdims[1:])) if d > 1 else 1
        self.cells_row = int(np.prod(n[1:])) if d > 1 else 1
        self.cells_per_dev = nxl * self.cells_row
        self.band_layers = 0
        # the local mesh is the first slab (a uniform lattice: the same
        # operators on every rank)
        self.hx = (self.hi[0] - self.lo[0]) / n[0]
        hi_l = self.hi.copy()
        hi_l[0] = self.lo[0] + nxl * self.hx
        self.local_mesh = _structured((nxl,) + tuple(n[1:]), tuple(self.lo), tuple(hi_l))
        self._make_ops(self.local_mesh)

    def _make_ops(self, local_mesh):
        self.ops = HaloSEMOperators(local_mesh, self.degree, self.dtype, self.device)
        self.ops.configure_halo(self.exchange, self.Lx, self.row_size)
        self.local_ndofs = self.ops.ndofs
        assert self.local_ndofs == self.Lx * self.row_size

    def _hybridize(self, mesh):
        """Bowl-fitted lattice: all deformation lies in the first
        ``blend_layers`` x-layers of cells, which must fit inside rank 0's
        slab. Rank 0's local operators become hybrid (its slab's true
        vertices, the uniform box as its lattice); the other ranks keep the
        uniform lattice."""
        n = self.grid
        bx = int(mesh.blend_layers)
        if bx > self.nxl:
            raise ValueError(
                f"hybrid slab sharding needs the blend band (blend_layers={bx} x-layers) "
                f"inside rank 0's slab ({self.nxl} layers); use <= {max(1, n[0] // bx)} "
                "ranks or run on one device")
        self.band_layers = bx
        if self.rank != 0:
            return
        gv = mesh.vertices.reshape(tuple(na + 1 for na in n) + (3,))
        local = self.local_mesh
        self.local_mesh = Mesh(dim=3, vertices=gv[: self.nxl + 1].reshape(-1, 3),
                               cells=local.cells, grid_shape=local.grid_shape,
                               uniform_hint=False, blend_layers=bx,
                               uniform_box=(self.lo.copy(), local.vertices.max(axis=0)))
        self._make_ops(self.local_mesh)
        if self.ops.hybrid is None:
            raise RuntimeError("rank 0's hybrid local operators failed to build")

    # ---- global <-> local DOF vectors -------------------------------------

    def to_local(self, vec, pad_value: float = 0.0) -> torch.Tensor:
        """This rank's slab [local_ndofs] of a global DOF vector ``vec``
        (array or tensor, [ndofs]): its rows including both interface
        planes, padding rows set to ``pad_value``; on this rank's device."""
        t = torch.as_tensor(vec).reshape(self.G0, self.row_size)
        start = self.rank * (self.Lx - 1)
        rows = t[start : start + self.Lx]
        out = torch.full((self.Lx, self.row_size), pad_value, dtype=self.dtype,
                         device=self.device)
        out[: rows.shape[0]] = rows.to(device=self.device, dtype=self.dtype)
        return out.reshape(-1)

    def gather_global(self, local: torch.Tensor) -> torch.Tensor:
        """The global vector [ndofs] from every rank's slab, on every rank
        (a collective): duplicated interface planes and padding rows
        dropped."""
        s = self.exchange.all_gather(local).reshape(self.ndev, self.Lx, self.row_size)
        full = torch.cat([s[0]] + [s[d, 1:] for d in range(1, self.ndev)])
        return full[: self.G0].reshape(-1)

    def locate_sensors(self, points):
        """Snap sensor ``points`` [dim, n] to the global GLL lattice: (the
        rank holding each [n], its local lattice coordinates [dim, n], axis 0
        the local row). Closed form (grid and GLL nodes), no mesh needed."""
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

    def _nodes_to_dev_loc(self, coords):
        """Global lattice node coordinates [dim, m] → (holding rank [m],
        local coordinates [dim, m]); an interface-plane node goes to the
        upper rank (the replicas are identical)."""
        dev = np.minimum(coords[0] // (self.Lx - 1), self.ndev - 1)
        r0 = coords[0] - dev * (self.Lx - 1)
        return dev, np.stack([r0] + [coords[a] for a in range(1, len(coords))])

    def dot_weights(self) -> torch.Tensor:
        """This rank's DOF weights [local_ndofs] making the sum over ranks of
        Σ_i w·a·b the global inner product: replicated interface planes
        weigh 1/2 on each holder, padding rows 0."""
        w = np.ones((self.Lx, self.row_size))
        if self.rank > 0:
            w[0] *= 0.5
        if self.rank < self.ndev - 1:
            w[-1] *= 0.5
        g0 = self.rank * (self.Lx - 1)
        w[max(self.G0 - g0, 0):] = 0.0  # padding rows: global row >= G0
        return torch.as_tensor(w.reshape(-1), dtype=self.dtype, device=self.device)

    def _local_cells(self, arr_cells) -> np.ndarray:
        """This rank's [cells_per_dev] of a global [Nc] cell array (axis-0
        padding cells 0)."""
        a = np.asarray(arr_cells, np.float64).reshape(-1, self.cells_row)
        if self.pad_cells:
            a = np.concatenate([a, np.zeros((self.pad_cells, self.cells_row))], axis=0)
        return a.reshape(self.ndev, self.cells_per_dev)[self.rank]

    def shard_consts(self, consts: dict, global_ndofs: int, global_ncells: int, stiff_keys=(),
                     raw_stiff=None, nodal_stiff_keys=(), raw_nodal=None, pad_one=()):
        """This rank's part of a model's consts: DOF vectors → its slab,
        cell vectors → its cells, scalars as they are. Keys in
        ``stiff_keys`` (DG-0 stiffness coefficients) and ``nodal_stiff_keys``
        (per-DOF coefficients, the sponge's δ) are packed here from the raw
        float64 values (``raw_stiff``/``raw_nodal``) into the local operators'
        format (K1's ``pack_const``/``pack_field`` on a 3D lattice, the
        lattice scales in 1D/2D, the hybrid dict on rank 0 of a bowl). Keys
        in ``pad_one`` pad with 1.0 (diagonals the solver divides by), the
        others with 0. The fused step's packed consts are left out."""
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

    def _pack_stiff_coeff(self, coeff):
        """This rank's packed DG-0 stiffness coefficient from the global
        [Nc] one: its cells (padding 0, so padding cells add nothing) in the
        local operators' format. The fold is over local cells only; the halo
        exchange completes the interface planes at run time."""
        return self.ops.stiff_coeff(self._local_cells(coeff))

    def _pack_nodal_coeff(self, nodal):
        """This rank's packed nodal stiffness coefficient (the sponge's δ):
        its lattice rows (padding rows 0), packed by ``pack_scales_nodal``."""
        if self.ops.lattice is None:
            raise ValueError("nodal stiffness coefficients need the lattice path")
        arr = np.asarray(nodal, np.float64).reshape(self.G0, self.row_size)
        start = self.rank * (self.Lx - 1)
        rows = np.zeros((self.Lx, self.row_size))
        part = arr[start : start + self.Lx]
        rows[: part.shape[0]] = part
        return self.ops.pack_scales_nodal(rows.reshape(-1))


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
    """What the explicit and the implicit sharded solvers share: the local
    state, its gather, the march and the sensor recording."""

    _streamed = False

    def _setup(self, model, ndev, device, pad_one=()):
        self.model = model
        self.dec = SlabDecomposition(model.mesh, model.degree, ndev, model.dtype,
                                     resolve_device(device))
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

    def _sensor_plan(self, points):
        """This rank's extractor of its sensors' nodes (padded to the most
        any rank holds) and the host reassembly map (rank, slot, weights):
        node-aligned sensors read their node, off-node ones interpolate
        through virtual nodes (``collapse_onehot``)."""
        dec = self.dec
        coords, wts = lattice_interp_nodes(dec, points)
        nodes, wts = collapse_onehot(coords, wts)
        dev, loc = dec._nodes_to_dev_loc(nodes)
        counts = np.bincount(dev, minlength=dec.ndev)
        slot = np.zeros(dev.size, np.int64)
        for r in range(dec.ndev):
            slot[dev == r] = np.arange(counts[r])
        mine = dev == dec.rank
        gd_local = (dec.Lx,) + tuple(dec.gdims[1:])
        idx = np.zeros(max(int(counts.max()), 1), np.int64)
        idx[: int(mine.sum())] = np.ravel_multi_index(tuple(loc[:, mine]), gd_local)
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


def build_sharded(model_factory, grid, lo, hi, degree, ndev, dtype, implicit: bool = False,
                  device="cuda"):
    """A sharded solver whose host memory is O(ndofs / ranks): each rank
    builds the model on its own slab only (the reference's "every MPI rank
    constructs its partition", ``cpp/fenicsx-sf/.../main.cpp:56-63``).

    ``model_factory(local_mesh) -> model`` builds the model on a slab mesh
    positioned in space: tag boundaries with position predicates (the
    interface x-planes must match none) and take DG-0 coefficients from
    ``local_mesh.cell_midpoints()``. A rank whose slab holds fewer cells gets
    a shorter mesh and inert padding; a rank with no cells builds its
    template on rank 0's slab and keeps none of its data.

    Models declare ``SHARD_INV_KEYS`` for consts stored as reciprocals of
    assembled diagonals (``inv_m``); every other [ndofs] const is taken as
    additively assembled, and its interface planes are summed with the
    neighbours' (the halo exchange of ``complete``: the setup data's
    ``scatter_rev(+)``). The solver starts from zero fields; ``rk``/``dirk``
    keep the local state and ``global_result()`` gathers it."""
    device = resolve_device(device)
    dec = SlabDecomposition.from_grid(grid, lo, hi, degree, ndev, dtype, device)
    n0, nxl, Lx, rs, p = grid[0], dec.nxl, dec.Lx, dec.row_size, degree
    c_lo = dec.rank * nxl
    tc = max(min(c_lo + nxl, n0) - c_lo, 0)
    true_rows = tc * p + 1 if tc else 0
    l0, h0 = dec.lo.copy(), dec.hi.copy()
    if tc:
        l0[0], h0[0] = dec.lo[0] + c_lo * dec.hx, dec.lo[0] + (c_lo + tc) * dec.hx
        model = model_factory(_structured((tc,) + tuple(grid[1:]), tuple(l0), tuple(h0)))
    else:
        h0[0] = dec.lo[0] + nxl * dec.hx
        model = model_factory(_structured((nxl,) + tuple(grid[1:]), tuple(l0), tuple(h0)))
    cls = type(model)
    inv_keys = tuple(getattr(cls, "SHARD_INV_KEYS", ()))
    pad_one = tuple(getattr(cls, "PAD_ONE_KEYS", ())) or (("m",) if implicit else ())
    stiff_keys = tuple(getattr(cls, "STIFF_KEYS", ()))
    nodal_keys = tuple(getattr(cls, "NODAL_STIFF_KEYS", ()))

    consts, raw = {}, {}
    for k, val in model.consts.items():
        if k.endswith(FUSED_STEP_SUFFIXES):
            continue
        if k in stiff_keys:
            full = np.zeros(dec.cells_per_dev)
            if tc:
                coeff = np.asarray(model.raw_stiff[k], np.float64).reshape(-1)
                full[: tc * dec.cells_row] = np.broadcast_to(coeff, (tc * dec.cells_row,))
            consts[k] = dec.ops.stiff_coeff(full)
        elif k in nodal_keys:
            full = np.zeros((Lx, rs))
            if tc:
                full[:true_rows] = np.asarray(model.raw_nodal[k], np.float64).reshape(true_rows, rs)
            consts[k] = dec.ops.pack_scales_nodal(full.reshape(-1))
        elif isinstance(val, (int, float)) or getattr(val, "ndim", None) == 0:
            consts[k] = val
        else:
            arr = _host64(val)
            if arr.size != model.ops.ndofs:
                raise ValueError(f"const {k}: shape {arr.shape} not a dof vector; declare "
                                 "STIFF_KEYS/NODAL_STIFF_KEYS")
            full = np.zeros((Lx, rs))
            if tc:
                a = arr.reshape(true_rows, rs)
                if k in inv_keys:  # back to the assembled diagonal
                    a = np.where(a != 0.0, 1.0 / np.where(a == 0.0, 1.0, a), 0.0)
                full[:true_rows] = a
            raw[k] = full
    for k, full in raw.items():
        # the shared interface planes: add the neighbours' partial sums
        a = dec.ops.complete(torch.as_tensor(full.reshape(-1), dtype=torch.float64,
                                             device=device)).reshape(Lx, rs)
        if k in inv_keys:
            a = torch.where(a != 0.0, 1.0 / torch.where(a == 0.0, 1.0, a), 0.0)
        if k in pad_one and true_rows < Lx:
            a[true_rows:] = 1.0
        consts[k] = a.reshape(-1).to(dtype)

    solver = object.__new__(ShardedImplicitSolver if implicit else ShardedExplicitSolver)
    solver.model, solver.dec, solver.consts = model, dec, consts
    solver._streamed = True
    if implicit:
        solver.weights = dec.dot_weights()
    return solver
