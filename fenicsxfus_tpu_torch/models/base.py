"""Shared base for the spectral wave models.

Port of ``fenicsxfus_tpu/models/base.py`` (``source_amplitudes``,
``SpectralModelBase``, ``ExplicitModelBase``): material coefficients (scalar
or cell-wise DG-0), the windowed transducer source g(t) on facet tag 1, the
Sommerfeld ABC on facet tag 2, point sensors, and the explicit-RK driver
with in-loop recording (``rk_record``). The step is the fused one (one K2
launch per RK stage; K5a then K5b with ``FUS_STAGE_V3=0``; one K3 launch per
RK4 step with ``FUS_STEP_WAVE=1``) when the model declares a fused kind and
its boundary vectors live on the box faces, unless ``FUS_FUSED=0``;
otherwise the reference a-vector RK step over ``rhs_pure`` (K1, or K4a then
K4b with ``FUS_V3=0``, plus elementwise torch).

On a hybrid (bowl-fitted) lattice the fused step is K2 with its band
operand, the slab correction K6 of each stage's fields formed before the
launch (``FusedRKStage.make_step(band_fn=...)``); ``FUS_STAGE_V3=0`` or
``FUS_HYBRID_FUSED=0`` takes the unfused step there, and K3 is never taken.
Sensors snap against the uniform box's origin, and inside the deformed slab
against the true node coordinates. On 1D and 2D lattices the step is the
unfused one (the stiffness is ``LatticeStiffness.apply_scaled``). On the
general per-cell path (no lattice: unstructured and deformed meshes, the
bowl mesh under ``FUS_HYBRID=0``) the step is the unfused one over the
general ``stiffness_apply``, and sensors are located on the true cells (a
KD-tree over the DOF coordinates, the Newton inverse map of
``utils.compute_eval_params``), as in the JAX package.

``ImplicitModelBase`` is the SDIRK driver (``dirk``, ``dirk_record``): each
stage solves (M + τ-terms)·kv = b by Jacobi-preconditioned CG
(``ops/cg.py``), whose matvec is the model's ``lhs_pure``; on a 3D lattice
that is K1 once per CG iteration, and ``rhs_stage`` once per stage.
"""

from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch

from ..analysis.timing import span
from ..core.gll import gll_points_weights_01, lagrange_eval_gll
from ..core.space import cell_node_coords
from ..ops.cg import cg_solve
from ..ops.operators import SEMOperators
from ..ops.stage import KIND_DENSE, KIND_FACET, FusedRKStage, pack_facet_vector, stage_fields
from ..ops.stage_ab import FusedRKStageAB
from ..ops.step_wave import FusedRKStepWave, try_separate_field
from ..utils import compute_eval_params
from .common import (
    dirk_tables,
    explicit_tables,
    make_recording_scan,
    make_rk_step,
    make_scan_from_step,
    run_steps,
    source_window,
    step_sizes,
)


def _cellwise(val, num_cells):
    """DG-0 coefficient as a float64 numpy [Nc] array."""
    arr = np.asarray(val, dtype=np.float64)
    if arr.ndim == 0:
        return np.full(num_cells, float(arr))
    if arr.shape != (num_cells,):
        raise ValueError(f"DG-0 coefficient must be a scalar or [{num_cells}]")
    return arr


def source_amplitudes(consts: dict, t: float) -> tuple[float, float]:
    """g(t), dg/dt(t) for the windowed CW transducer drive, on the host in
    float64 (reference ``_lossy.py:169-189``)."""
    win, dwin = source_window(t, consts["freq"], consts["alpha"])
    p0, w0, s0 = consts["p0"], consts["w0"], consts["s0"]
    amp = p0 * w0 / s0
    g = win * amp * math.cos(w0 * t)
    dg = dwin * amp * math.cos(w0 * t) - win * p0 * w0**2 / s0 * math.sin(w0 * t)
    return g, dg


class SpectralModelBase:
    """Common state: operators, coefficients, source, u_n/v_n storage."""

    SOURCE_TAG = 1
    ABC_TAG = 2

    def __init__(self, mesh, meshtags, degree, freq0, p0, s0, dt, dtype, device):
        if meshtags is not None:
            mesh.facet_tags = dict(meshtags)
        self.mesh = mesh
        self.degree = degree
        self.dtype = dtype
        self.freq = float(freq0)
        self.w0 = 2.0 * np.pi * self.freq
        self.p0 = float(p0)
        self.s0 = float(s0)
        self.alpha = 4.0  # source window length in periods (reference default)
        self.dt = float(dt)
        self.ops = SEMOperators(mesh, degree, dtype=dtype, device=device)
        self.device = self.ops.device
        self.init()
        self.t = 0.0

    def base_consts(self) -> dict:
        """Scalar constants every model's slope function needs."""
        return {
            "freq": self.freq,
            "w0": self.w0,
            "p0": self.p0,
            "s0": self.s0,
            "alpha": self.alpha,
        }

    def init(self):
        """Zero initial conditions (reference ``init()``)."""
        self.u_n = torch.zeros(self.ops.ndofs, dtype=self.dtype, device=self.device)
        self.v_n = torch.zeros(self.ops.ndofs, dtype=self.dtype, device=self.device)
        return self

    def number_of_dofs(self) -> int:
        return self.ops.ndofs

    # -- point sensors -----------------------------------------------------

    def _lattice_origin(self) -> np.ndarray:
        """The lattice's origin: on a hybrid lattice the uniform box's, not
        ``vertices.min()`` (the pulled-back cap shifts the minimum by a
        sagitta, about 1.3 cells, which would displace every sensor)."""
        if self.ops.hybrid is not None:
            return np.asarray(self.mesh.uniform_box[0], np.float64)
        return self.mesh.vertices.min(axis=0)

    def _in_band(self, pts) -> np.ndarray:
        """Which of ``pts`` [dim, n] lie in the deformed slab of a hybrid
        lattice (all False on a uniform one)."""
        hyb = self.ops.hybrid
        if hyb is None:
            return np.zeros(pts.shape[1], bool)
        depth = self._lattice_origin()[0] + hyb["bx"] * self.ops.lattice.h[0]
        return pts[0] < depth

    def _lattice_coords(self, points):
        """Per axis, the lattice cell of each of ``points`` [dim, n] and its
        reference coordinate in [0, 1]."""
        pts = np.asarray(points, np.float64)
        lat = self.ops.lattice
        lo = self._lattice_origin()
        cells, xis = [], []
        for a in range(self.mesh.dim):
            s = (pts[a] - lo[a]) / lat.h[a]
            c = np.clip(np.floor(s).astype(np.int64), 0, lat.grid[a] - 1)
            cells.append(c)
            xis.append(np.clip(s - c, 0.0, 1.0))
        return cells, xis

    def sensor_indices(self, points) -> np.ndarray:
        """Nearest-DOF indices for sensor ``points`` [dim, n], snapped in
        closed form per lattice axis (exact for sensors placed on nodes).
        Inside the deformed slab of a hybrid lattice the logical lattice
        positions are not the physical ones: those points take the nearest
        true node of the slab's cells (a KD-tree over the slab only). On
        the general path: the nearest DOF by a KD-tree over all of them."""
        from scipy.spatial import cKDTree

        lat = self.ops.lattice
        if lat is None:
            pts = np.asarray(points, np.float64)
            return cKDTree(self.ops.dof_coords()).query(pts.T)[1].astype(np.int64)
        gll, _ = gll_points_weights_01(lat.N)
        cells, xis = self._lattice_coords(points)
        per_axis = [c * lat.p + np.argmin(np.abs(xi[:, None] - gll[None, :]), axis=1)
                    for c, xi in zip(cells, xis)]
        idx = np.ravel_multi_index(per_axis, lat.gdims)
        pts = np.asarray(points, np.float64)
        inside = self._in_band(pts)
        if inside.any():
            nb = self.ops.hybrid["nb"]
            dofs_b = np.asarray(self.ops.space.dofmap_for_cells(np.arange(nb))).reshape(-1)
            coords_b = cell_node_coords(self.mesh, lat.N, cells=np.arange(nb)).reshape(
                -1, self.mesh.dim)
            idx[inside] = dofs_b[cKDTree(coords_b).query(pts[:, inside].T)[1]]
        return idx

    def _locate_sensors(self, points):
        """(cells [n], xi [n, dim]) of sensor ``points`` [dim, n]: the lattice
        cell of each point and its reference coordinates; inside the deformed
        slab of a hybrid lattice, and everywhere on the general path, the
        Newton inverse map of the true cells (``utils.compute_eval_params``)."""
        pts = np.asarray(points, np.float64)
        if self.ops.lattice is None:
            _, fc, fx = compute_eval_params(self.mesh, pts)
            if len(fc) != pts.shape[1]:
                raise ValueError(
                    f"{pts.shape[1] - len(fc)} sensor point(s) lie outside the mesh")
            return fc, fx
        cells, xis = self._lattice_coords(pts)
        cells = np.ravel_multi_index(cells, self.ops.lattice.grid)
        xis = np.stack(xis, axis=1)
        inside = self._in_band(pts)
        if inside.any():
            _, fc, fx = compute_eval_params(self.mesh, pts[:, inside])
            if len(fc) != int(inside.sum()):
                raise ValueError("sensor point outside the mesh")
            cells[inside] = fc
            xis[inside] = fx
        return cells, xis

    def sensor_interp_tables(self, points):
        """Interpolating sensor tables: (rows [n, N**d] flat DOF indices,
        wts [n, N**d] Lagrange weights), ``Function.eval`` semantics for
        off-node sensors (the reference interpolates,
        ``cpp/mwe/parallel_eval_line/main.cpp:49-107``). The weight row of a
        sensor on a node is one-hot."""
        cells, xis = self._locate_sensors(points)
        rows = np.asarray(self.ops.space.dofmap_for_cells(cells), np.int64).reshape(len(cells), -1)
        N = self.ops.N
        w = lagrange_eval_gll(N, xis[:, 0])
        for a in range(1, xis.shape[1]):
            t = lagrange_eval_gll(N, xis[:, a])
            w = (w[:, :, None] * t[:, None, :]).reshape(len(cells), -1)
        return rows, w

    def _record_plan(self, points):
        """Per-step sensor extractor ``u -> [n]`` for ``points`` [dim, n]:
        a nearest-DOF gather when every sensor sits on a node (every weight
        row one-hot), else the interpolating gather (no snap-to-node phase
        error for off-node sensors)."""
        rows, wts = self.sensor_interp_tables(points)
        amax = np.abs(wts).max(axis=1)
        if np.all(amax >= 1.0 - 1e-9):
            idx = rows[np.arange(len(rows)), np.abs(wts).argmax(axis=1)]
            return self._sensor_extractor(idx)
        return self._sensor_extractor_interp(rows, wts)

    def _sensor_extractor(self, idx: np.ndarray):
        """Nearest-DOF extraction: an index gather on the flat field view."""
        it = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        return lambda u: u.reshape(-1).index_select(0, it)

    def _sensor_extractor_interp(self, rows: np.ndarray, wts: np.ndarray):
        """Interpolating extraction: gather the N**d nodes of each sensor's
        cell and contract with its Lagrange weights (any numbering: the
        rows are flat DOF indices)."""
        rt = torch.as_tensor(rows, device=self.device)
        wt = torch.as_tensor(wts, dtype=self.dtype, device=self.device)
        return lambda u: (u.reshape(-1)[rt] * wt).sum(-1)


class ExplicitModelBase(SpectralModelBase):
    """Explicit-RK models: subclasses define ``rhs_pure(ops, consts, t, u, v)``."""

    def __init__(self, mesh, meshtags, degree, freq0, p0, s0, rk_order, dt, dtype, device):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, dt, dtype, device)
        self.rk_order = int(rk_order)
        # every device tensor / scalar the slope function needs
        self.consts: dict = {}
        self._solve = None  # built lazily after subclass setup
        self.step_kind = None  # "fused" or "unfused" once built
        self.stage_cls = None  # the stage class of the last fused step built

    def unfused_step(self, ops=None):
        """The reference a-vector RK step over ``rhs_pure`` (K1 per stage);
        ``ops`` replaces the model's operators (``ops.plain()`` runs the
        plain stiffness). A model with no ``rhs_pure`` (the Gauss-quadrature
        ``LinearExplicit``) steps over its instance ``rhs(t, u, v)``, its
        data held by the instance, as in the JAX package."""
        if not hasattr(type(self), "rhs_pure"):
            return make_rk_step(lambda consts, t, u, v: self.rhs(t, u, v), self.rk_order)
        ops, rhs_pure = self.ops if ops is None else ops, type(self).rhs_pure
        return make_rk_step(
            lambda consts, t, u, v: rhs_pure(ops, consts, t, u, v), self.rk_order
        )

    def fused_step(self, stage_fn=None):
        """The fused step (one ``stage_fn`` call per RK stage, or per step
        on the wave class), or None when ``FUS_FUSED=0`` forces the unfused
        step, the model declares no fused kind, there is no lattice (the
        general per-cell path: its coefficients are [Nc] tensors, not
        packed), the lattice is 1D or 2D (no stage kernel, as the JAX
        package has no Pallas stage there), a stiffness coefficient is not
        packed, or a boundary vector has interior support.

        The switches, read here when the step is built (as the JAX package's
        ``_try_fused_step`` reads them), pick the kernels: one K2 launch per
        stage (``ops.stage.FusedRKStage``, the default); with
        ``FUS_STAGE_V3=0`` the two-kernel stage, K5a then K5b
        (``ops.stage_ab.FusedRKStageAB``); with ``FUS_STEP_WAVE=1``, unless
        ``FUS_STAGE_V3=0``, and at ``rk_order == 4`` only, one K3 launch per
        step (``ops.step_wave.FusedRKStepWave``), with inv_m passed
        separable (``consts["inv_m__sep0"]``/``["inv_m__sepP"]``) when it is
        rank one. ``self.stage_cls`` names the class taken. ``stage_fn``
        replaces the kernels with a function of the same signature:
        ``stage_plain``, ``stage_ab_plain`` or ``step_wave_plain`` runs the
        plain path on any device.

        On a hybrid (bowl-fitted) lattice, as in the JAX package: None under
        ``FUS_STAGE_V3=0`` or ``FUS_HYBRID_FUSED=0`` (the two-kernel stage
        has no band operand), never K3 whatever ``FUS_STEP_WAVE`` says, and
        otherwise K2 on the uniform parts ``hyb_u`` of the coefficients with
        the band operand formed per stage by ``_band_fn``."""
        kind = type(self).__dict__.get("FUSED_KIND")
        if (not kind or self.ops.lattice is None or self.ops.d != 3
                or os.environ.get("FUS_FUSED", "") == "0"):
            return None
        hybrid = self.ops.hybrid is not None
        if hybrid and (os.environ.get("FUS_STAGE_V3", "1") == "0"
                       or os.environ.get("FUS_HYBRID_FUSED", "1") == "0"):
            return None
        keys = type(self).STIFF_KEYS
        if not all(isinstance(self.consts.get(k), dict) for k in keys):
            return None
        dense_keys, facet_keys = KIND_DENSE[kind], KIND_FACET[kind]
        if not all(k in self.consts for k in dense_keys + facet_keys):
            return None
        gdims = self.ops.gdims
        # pack the facet vectors once; any interior support means the model
        # is not in the pure boundary-term family → unfused step
        for k in facet_keys:
            if k + "__pf" not in self.consts:
                packed = pack_facet_vector(self.consts[k].cpu().numpy(), gdims)
                if packed is None:
                    return None
                self.consts[k + "__pf"] = {
                    n: self.ops.to_device(v) for n, v in packed.items()
                }
        two_kernel = os.environ.get("FUS_STAGE_V3", "1") == "0"
        stage_cls = FusedRKStageAB if two_kernel else FusedRKStage
        dense_get = lambda c: [c[k].view(gdims) for k in dense_keys]  # noqa: E731
        if (not two_kernel and not hybrid and self.rk_order == 4
                and os.environ.get("FUS_STEP_WAVE", "") == "1"):
            stage_cls = FusedRKStepWave
            if dense_keys == ("inv_m",) and "inv_m__sep0" not in self.consts:
                sep = try_separate_field(self.consts["inv_m"].cpu().numpy(), gdims)
                if sep is not None:
                    self.consts["inv_m__sep0"], self.consts["inv_m__sepP"] = (
                        self.ops.to_device(x) for x in sep)
            if "inv_m__sep0" in self.consts:
                dense_get = lambda c: [c["inv_m__sep0"], c["inv_m__sepP"]]  # noqa: E731
        self.stage_cls = stage_cls
        stage = stage_cls(gdims, self.degree, kind, explicit_tables(self.rk_order))
        extras = lambda c: (dense_get(c), [c[k + "__pf"] for k in facet_keys])  # noqa: E731
        if hybrid:
            return stage.make_step(lambda c: [c[k]["hyb_u"] for k in keys], extras,
                                   stage_fn=stage_fn, band_fn=self._band_fn(keys))
        return stage.make_step(lambda c: [c[k] for k in keys], extras, stage_fn=stage_fn)

    def _band_fn(self, keys):
        """The band operand of a stage on a hybrid lattice: the slab rows of
        the stage fields un (and vn), formed as the stage forms them
        (``ops.stage.stage_fields``, the JAX package's ``band_fn``), through
        the slab correction K6 (``ops.band_correction_rows``)."""
        ops, sx = self.ops, self.ops.hybrid["slab_x"]

        def band_fn(c, u0, v0, kvp, kvpp, alpha, beta):
            un, vn = stage_fields(u0[:sx], v0[:sx], None if kvp is None else kvp[:sx],
                                  None if kvpp is None else kvpp[:sx], alpha, beta)
            cs = [c[k] for k in keys]
            return ops.band_correction_rows([un, vn][: len(keys)], [cc["hyb_b"] for cc in cs],
                                            cs[0]["hyb_G"])

        return band_fn

    def _make_step(self):
        step = self.fused_step()
        self.step_kind = "unfused" if step is None else "fused"
        return self.unfused_step() if step is None else step

    def _build(self):
        self._solve = make_scan_from_step(self._make_step())

    def rk(self, t0: float, tf: float):
        if self._solve is None:
            self._build()
        u, v, t = self._solve(self.consts, self.u_n, self.v_n, t0, tf, self.dt)
        self.u_n, self.v_n, self.t = u, v, float(t)
        return self.u_n, self.v_n, self.t

    def rk_record(self, t0: float, tf: float, points):
        """Time-march like ``rk`` while recording u at sensor ``points``
        [dim, n] after every step, on the device inside the loop. Returns
        (u, v, t, times [n_steps] float64 numpy, ys [n_steps, n] device
        tensor). The spans of the per-call plan are opened here, not in
        ``_make_step`` and ``_record_plan``, so that the constructor's
        ``_build`` stays a set-up cost."""
        with span("fus.rk_record"):
            with span("fus.loop.step_build"):
                step = self._make_step()
            with span("fus.loop.sensor_plan"):
                record = self._record_plan(points)
            with span("fus.loop.march"):
                solve = make_recording_scan(step, record)
                u, v, t, ys = solve(self.consts, self.u_n, self.v_n, t0, tf, self.dt)
            times = t0 + np.cumsum(step_sizes(t0, tf, self.dt))
        self.u_n, self.v_n, self.t = u, v, float(t)
        return u, v, float(t), times, ys


class ImplicitModelBase(SpectralModelBase):
    """SDIRK models: subclasses provide static functions over a ``consts``
    dict (as the JAX package's):

    * ``lhs_pure(ops, consts, tau, x) -> A x``   (A = M + τ-terms)
    * ``lhs_diag_pure(ops, consts, tau)``        (diag(A), Jacobi)
    * ``rhs_stage(ops, consts, tau, t, u, v) -> b``

    The instance methods ``lhs``/``lhs_diag``/``rhs`` are thin wrappers for
    direct use. After ``dirk`` or ``dirk_record``, ``cg_stats`` holds the
    worst CG iteration count and final ‖r‖² over the run's stage solves.
    """

    def __init__(self, mesh, meshtags, degree, freq0, p0, s0, rk_order, dt, dtype, device,
                 cg_rtol=1e-8, cg_maxiter=2000):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, dt, dtype, device)
        self.rk_order = int(rk_order)
        self.A_tab, self.b_tab, self.c_tab = dirk_tables(self.rk_order)
        self.cg_rtol = cg_rtol
        self.cg_maxiter = cg_maxiter
        self.consts: dict = {}
        self.cg_stats = None

    def lhs(self, tau, x):
        return type(self).lhs_pure(self.ops, self.consts, tau, x)

    def lhs_diag(self, tau):
        return type(self).lhs_diag_pure(self.ops, self.consts, tau)

    def rhs(self, tau, t, u, v):
        return type(self).rhs_stage(self.ops, self.consts, tau, t, u, v)

    def dirk_step(self, ops=None, stats=None, dot=None):
        """The SDIRK step ``step(consts, (u, v, t), dt) -> (u, v, t + dt)``
        (the JAX package's ``_build_run`` step): per stage, b from
        ``rhs_stage``, then CG on ``lhs_pure`` from the previous stage's kv
        (zero at the first stage). ``ops`` replaces the model's operators
        (``ops.plain()`` runs the plain stiffness; the slab decomposition
        passes a rank's local operators), ``dot`` the CG's inner product
        (``cg_solve``; the slab passes its reduced dot). Each step appends
        (worst CG iterations, worst final ‖r‖² as a 0-d tensor) over its
        stages to the list ``stats``, if given."""
        A_tab, b_tab, c_tab = self.A_tab, self.b_tab, self.c_tab
        ops = self.ops if ops is None else ops
        cls = type(self)
        rtol, maxiter = self.cg_rtol, self.cg_maxiter

        def step(consts, carry, dtn):
            u0, v0, t = carry
            tau = dtn * A_tab[0][0]
            dinv = 1.0 / cls.lhs_diag_pure(ops, consts, tau)
            kus, kvs = [], []
            u_acc, v_acc = u0, v0
            it_max, res_max = 0, torch.zeros((), dtype=v0.dtype, device=v0.device)
            for i in range(len(b_tab)):
                un, vn = u0, v0
                for j in range(i):
                    un = un + (A_tab[i][j] * dtn) * kus[j]
                    vn = vn + (A_tab[i][j] * dtn) * kvs[j]
                tn = t + c_tab[i] * dtn
                b = cls.rhs_stage(ops, consts, tau, tn, un, vn)
                x0 = kvs[-1] if kvs else torch.zeros_like(v0)
                kv, (it, res2) = cg_solve(
                    lambda x: cls.lhs_pure(ops, consts, tau, x), b, x0, dinv,
                    rtol=rtol, maxiter=maxiter, dot=dot,
                )
                it_max = max(it_max, it)
                res_max = torch.maximum(res_max, res2)
                ku = vn + tau * kv
                kus.append(ku)
                kvs.append(kv)
                u_acc = u_acc + (b_tab[i] * dtn) * ku
                v_acc = v_acc + (b_tab[i] * dtn) * kv
            if stats is not None:
                stats.append((it_max, res_max))
            return u_acc, v_acc, t + dtn

        return step

    def _march(self, t0: float, tf: float, record=None):
        """Run ``dirk_step`` over ``step_sizes(t0, tf, dt)`` from the model's
        state; set the state and ``cg_stats``, warn if a stage solve hit
        ``cg_maxiter``; return the step sizes."""
        stats = []
        dts = step_sizes(t0, tf, self.dt)
        u, v, t = run_steps(self.dirk_step(stats=stats), self.consts, self.u_n, self.v_n, t0,
                            dts, record=record)
        it_max = max(it for it, _ in stats)
        res_max = float(torch.stack([r for _, r in stats]).max())
        self.cg_stats = {"max_iterations": it_max, "max_residual2": res_max}
        if it_max >= self.cg_maxiter:
            warnings.warn(
                f"DIRK stage CG hit maxiter={self.cg_maxiter} "
                f"(worst final ||r||^2 = {res_max:.3e}) — solution suspect",
                stacklevel=3,
            )
        self.u_n, self.v_n, self.t = u, v, float(t)
        return dts

    def dirk(self, t0: float, tf: float):
        """Time-march with SDIRK; surfaces the worst CG iterations and final
        ‖r‖² over the run as ``self.cg_stats`` and warns if any stage solve
        hit ``cg_maxiter``."""
        self._march(t0, tf)
        return self.u_n, self.v_n, self.t

    def dirk_record(self, t0: float, tf: float, points):
        """``dirk`` while recording u at sensor ``points`` [dim, n] after
        every step, on the device (the implicit counterpart of
        ``ExplicitModelBase.rk_record``). Returns (u, v, t, times [n_steps]
        float64 numpy, ys [n_steps, n] device tensor)."""
        extract = self._record_plan(points)
        ys = []
        dts = self._march(t0, tf, record=lambda i, u: ys.append(extract(u)))
        times = t0 + np.cumsum(dts)
        return self.u_n, self.v_n, self.t, times, torch.stack(ys)
