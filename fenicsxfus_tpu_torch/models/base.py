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

The port's operators take uniform lattices only (``SEMOperators`` refuses
the rest), so the sensor code has the lattice branch alone; the hybrid
(bowl-deformed) branches arrive with the bowl slice.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..core.gll import gll_points_weights_01, lagrange_eval_gll
from ..ops.operators import SEMOperators
from ..ops.stage import KIND_DENSE, KIND_FACET, FusedRKStage, pack_facet_vector
from ..ops.stage_ab import FusedRKStageAB
from ..ops.step_wave import FusedRKStepWave, try_separate_field
from .common import (
    explicit_tables,
    make_recording_scan,
    make_rk_step,
    make_scan_from_step,
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

    def _lattice_coords(self, points):
        """Per axis, the lattice cell of each of ``points`` [dim, n] and its
        reference coordinate in [0, 1]."""
        pts = np.asarray(points, np.float64)
        lat = self.ops.lattice
        lo = self.mesh.vertices.min(axis=0)
        cells, xis = [], []
        for a in range(self.mesh.dim):
            s = (pts[a] - lo[a]) / lat.h[a]
            c = np.clip(np.floor(s).astype(np.int64), 0, lat.grid[a] - 1)
            cells.append(c)
            xis.append(np.clip(s - c, 0.0, 1.0))
        return cells, xis

    def sensor_indices(self, points) -> np.ndarray:
        """Nearest-DOF indices for sensor ``points`` [dim, n], snapped in
        closed form per lattice axis (exact for sensors placed on nodes)."""
        lat = self.ops.lattice
        gll, _ = gll_points_weights_01(lat.N)
        cells, xis = self._lattice_coords(points)
        per_axis = [c * lat.p + np.argmin(np.abs(xi[:, None] - gll[None, :]), axis=1)
                    for c, xi in zip(cells, xis)]
        return np.ravel_multi_index(per_axis, lat.gdims)

    def _locate_sensors(self, points):
        """(cells [n], xi [n, dim]) of sensor ``points`` [dim, n]: the lattice
        cell of each point and its reference coordinates."""
        cells, xis = self._lattice_coords(points)
        return np.ravel_multi_index(cells, self.ops.lattice.grid), np.stack(xis, axis=1)

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
        cell and contract with its Lagrange weights."""
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

    def unfused_step(self):
        """The reference a-vector RK step over ``rhs_pure`` (K1 per stage)."""
        ops, rhs_pure = self.ops, type(self).rhs_pure
        return make_rk_step(
            lambda consts, t, u, v: rhs_pure(ops, consts, t, u, v), self.rk_order
        )

    def fused_step(self, stage_fn=None):
        """The fused step (one ``stage_fn`` call per RK stage, or per step
        on the wave class), or None when ``FUS_FUSED=0`` forces the unfused
        step, the model declares no fused kind, a stiffness coefficient is
        not packed, or a boundary vector has interior support.

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
        plain path on any device."""
        kind = type(self).__dict__.get("FUSED_KIND")
        if not kind or os.environ.get("FUS_FUSED", "") == "0":
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
        if (not two_kernel and self.rk_order == 4
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
        return stage.make_step(
            lambda c: [c[k] for k in keys],
            lambda c: (dense_get(c), [c[k + "__pf"] for k in facet_keys]),
            stage_fn=stage_fn,
        )

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
        tensor)."""
        solve = make_recording_scan(self._make_step(), self._record_plan(points))
        u, v, t, ys = solve(self.consts, self.u_n, self.v_n, t0, tf, self.dt)
        times = t0 + np.cumsum(step_sizes(t0, tf, self.dt))
        self.u_n, self.v_n, self.t = u, v, float(t)
        return u, v, float(t), times, ys
