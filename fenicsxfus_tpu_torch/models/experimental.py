"""Experimental solvers (port of ``fenicsxfus_tpu/models/experimental.py``;
reference ``python/src/fenicsxfus/_experimental.py``):

* ``LinearSpectralNewmark`` — Newmark-β time stepping (:13-251): one CG
  solve a step (``ops/cg.py``), its matvec one stiffness apply (K1 on a 3D
  lattice, in fp64 by default);
* ``LinearSpectralS2`` — a spatially windowed source f(x,t) = s(x)·g(t)
  (:254-540); the unfused RK step, K1 once a stage on a 3D lattice;
* ``LinearSpectralSponge`` — a spatially varying δ(x) sponge-layer absorber
  (:715-984); the unfused RK step: K1 for the 1/ρ-scaled c² stiffness plus
  the nodal-δ apply (``SEMOperators.stiffness_apply_nodal``, torch ops);
* ``LinearSpectralAdaptive`` (alias ``LinearSpectralSciPy``) and
  ``WesterveltSpectralAdaptive`` (alias ``WesterveltSpectralSciPy``) —
  adaptive Dormand-Prince RK5(4) (:543-712, :987-1188), seven slopes an
  attempt, each one ``rhs_pure`` (K1 on a 3D lattice).

The JAX package's ``lax.while_loop`` of the adaptive controller is a host
loop here, with one host read of the error norm an attempt (as the CG reads
‖r‖²): it takes the accepts, rejects and attempts of the JAX run in fp64.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..ops.cg import cg_solve
from .base import ExplicitModelBase, SpectralModelBase, _cellwise, source_amplitudes
from .common import step_sizes
from .linear import LinearSpectralExplicit
from .westervelt import WesterveltSpectralExplicit

# --------------------------------------------------------------------------
# Spatial source windows (the reference's commented-out menu,
# ``_experimental.py:383-439``, exposed as first-class profiles)


def heaviside_window(a: float, b: float, axis: int = 1):
    """s(x) = 1 on a <= x_axis <= b, else 0 (the reference's active choice)."""

    def profile(x):
        xi = x[axis]
        return np.where((xi >= a) & (xi <= b), 1.0, 0.0)

    return profile


def tukey_window(a: float, b: float, axis: int = 1):
    """Tapered-cosine: 1 on |x|<=a, cosine roll-off to 0 at |x|=b."""

    def profile(x):
        xi = np.abs(x[axis])
        ramp = 0.5 * (1 + np.cos(np.pi * (xi - a) / (b - a)))
        return np.where(xi <= a, 1.0, np.where(xi <= b, ramp, 0.0))

    return profile


def semicircle_window(r0: float, axis: int = 1):
    def profile(x):
        xi = x[axis]
        return np.where(np.abs(xi) <= r0, np.sqrt(np.maximum(r0**2 - xi**2, 0.0)) / r0, 0.0)

    return profile


def double_heaviside_window(a: float, b: float, c: float, d: float, axis: int = 1):
    def profile(x):
        xi = x[axis]
        return np.where(((xi >= a) & (xi <= b)) | ((xi >= c) & (xi <= d)), 1.0, 0.0)

    return profile


# --------------------------------------------------------------------------


class LinearSpectralS2(ExplicitModelBase):
    """Linear solver with a spatially windowed source s(x)·g(t)
    (reference ``_experimental.py:254-540``; default window = Heaviside on
    x₁ ∈ [−0.011, 0.011] matching :431-439). It declares no fused kind, so
    it takes the unfused step."""

    STIFF_KEYS = ("coeff_u",)

    def __init__(self, mesh, meshtags, degree, c0, rho0, freq0, p0, s0,
                 source_profile=None, dtype=torch.float32, device="cuda"):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, 4, 0.0, dtype, device)
        nc = mesh.num_cells
        c = _cellwise(c0, nc)
        rho = _cellwise(rho0, nc)
        ops = self.ops
        profile = source_profile or heaviside_window(-0.011, 0.011)
        prof_nodal = np.asarray(profile(ops.space.dof_coords.T), np.float64)
        self.consts = self.base_consts()
        self.consts["inv_m"] = ops.to_device(1.0 / ops.assemble_diag(1.0 / (rho * c * c)))
        self.raw_stiff = {"coeff_u": 1.0 / rho}
        self.consts["coeff_u"] = ops.stiff_coeff(1.0 / rho)
        # ∫_Γ1 (1/ρ) s(x) φ ds — profile folded into the facet vector with
        # the per-cell 1/ρ (NOT a scalar mean; the medium may vary there)
        self.consts["src_vec"] = ops.to_device(
            ops.facet_vector_nodal(self.SOURCE_TAG, prof_nodal, cell_coeff=1.0 / rho))
        self.consts["abc_diag"] = ops.to_device(ops.facet_vector(self.ABC_TAG, 1.0 / (rho * c)))
        self._build()

    rhs_pure = staticmethod(LinearSpectralExplicit.rhs_pure)

    def rk4(self, t0: float, tf: float, dt: float):
        self.dt = float(dt)
        self._build()
        return self.rk(t0, tf)


class LinearSpectralNewmark(SpectralModelBase):
    """Newmark-β (γ=1/2, β=1/4) linear solver
    (reference ``_experimental.py:13-251``). Each step solves
    (M + γ·dt·ABC + β·dt²·K) w_{n+1} = b(u_n, v_n, w_n, t_{n+1}) by
    matrix-free Jacobi-preconditioned CG from w_n (the reference applies a
    single Jacobi sweep, KSP PREONLY + PC Jacobi, :117-120). The operands
    sit in ``consts`` (``m``, the packed 1/ρ ``coeff_u``, ``kdiag``,
    ``src_vec``, ``abc_diag``); after ``newmark``, ``cg_stats`` holds the
    worst CG iterations and final ‖r‖² over the run's steps."""

    def __init__(self, mesh, meshtags, degree, c0, rho0, freq0, p0, s0, dt,
                 dtype=torch.float64, device="cuda", cg_rtol=1e-10, cg_maxiter=2000):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, dt, dtype, device)
        self.gamma = 0.5
        self.beta = 0.25
        self.cg_rtol = cg_rtol
        self.cg_maxiter = cg_maxiter
        self.cg_stats = None
        nc = mesh.num_cells
        c = _cellwise(c0, nc)
        rho = _cellwise(rho0, nc)
        ops = self.ops
        self.consts = self.base_consts()
        self.consts["m"] = ops.to_device(ops.assemble_diag(1.0 / (rho * c * c)))
        self.consts["coeff_u"] = ops.stiff_coeff(1.0 / rho)  # packed once
        self.consts["kdiag"] = ops.stiffness_diag(1.0 / rho)
        self.consts["src_vec"] = ops.to_device(ops.facet_vector(self.SOURCE_TAG, 1.0 / rho))
        self.consts["abc_diag"] = ops.to_device(ops.facet_vector(self.ABC_TAG, 1.0 / (rho * c)))

    def init(self):
        super().init()
        self.w_n = torch.zeros(self.ops.ndofs, dtype=self.dtype, device=self.device)
        return self

    def newmark_step(self, ops=None, stats=None):
        """The Newmark step ``step(consts, (u, v, w, t), dt) -> (u, v, w, t
        + dt)`` (the JAX package's ``step``): b from the predictor, then CG
        on (M + γ·dt·ABC + β·dt²·K) from w. ``ops`` replaces the model's
        operators (``ops.plain()`` runs the plain stiffness). Each step
        appends (CG iterations, final ‖r‖² as a 0-d tensor) to the list
        ``stats``, if given."""
        gamma, beta = self.gamma, self.beta
        ops = self.ops if ops is None else ops
        rtol, maxiter = self.cg_rtol, self.cg_maxiter

        def A(c, dtn, x):
            return (c["m"] * x + (gamma * dtn) * c["abc_diag"] * x
                    + (beta * dtn * dtn) * ops.stiffness_apply([x], [c["coeff_u"]]))

        def step(c, carry, dtn):
            u0, v0, w0, t = carry
            t1 = t + dtn
            g, _ = source_amplitudes(c, t1)
            # the predictor combination enters the stiffness argument
            upred = u0 + dtn * v0 + 0.5 * dtn * dtn * (1 - 2 * beta) * w0
            b = (
                -c["abc_diag"] * (v0 + (1 - gamma) * dtn * w0)
                - ops.stiffness_apply([upred], [c["coeff_u"]])
                + g * c["src_vec"]
            )
            dinv = 1.0 / (c["m"] + (gamma * dtn) * c["abc_diag"]
                          + (beta * dtn * dtn) * c["kdiag"])
            w1, (it, res2) = cg_solve(lambda x: A(c, dtn, x), b, w0, dinv,
                                      rtol=rtol, maxiter=maxiter)
            if stats is not None:
                stats.append((it, res2))
            v1 = v0 + (1 - gamma) * dtn * w0 + gamma * dtn * w1
            u1 = u0 + dtn * v0 + 0.5 * dtn * dtn * ((1 - 2 * beta) * w0 + 2 * beta * w1)
            return u1, v1, w1, t1

        return step

    def newmark(self, t0: float, tf: float):
        """March from the model's state over ``step_sizes(t0, tf, dt)``, each
        step starting at its float64 host time; set the state and
        ``cg_stats``, warn if a solve hit ``cg_maxiter``. Returns (u, v, w,
        t)."""
        stats = []
        step = self.newmark_step(stats=stats)
        dts = np.asarray(step_sizes(t0, tf, self.dt), np.float64)
        ts = float(t0) + np.concatenate([[0.0], np.cumsum(dts)[:-1]])
        u, v, w, t = self.u_n, self.v_n, self.w_n, float(t0)
        for dtn, tn in zip(dts.tolist(), ts.tolist()):
            u, v, w, t = step(self.consts, (u, v, w, tn), dtn)
        it_max = max(it for it, _ in stats)
        res_max = float(torch.stack([r for _, r in stats]).max())
        self.cg_stats = {"max_iterations": it_max, "max_residual2": res_max,
                         "iterations": [it for it, _ in stats]}
        if it_max >= self.cg_maxiter:
            warnings.warn(f"Newmark CG hit maxiter={self.cg_maxiter} (worst final ||r||^2 = "
                          f"{res_max:.3e}) — solution suspect", stacklevel=2)
        self.u_n, self.v_n, self.w_n, self.t = u, v, w, float(t)
        return self.u_n, self.v_n, self.w_n, self.t


class LinearSpectralSponge(ExplicitModelBase):
    """Linear solver with a spatially-varying δ(x) sponge-layer absorber
    (reference ``_experimental.py:715-984``): δ ramps linearly from 0 at
    ``sponge_start`` (default 0.12, reference :770-780), damping outgoing
    waves in the pad region. Note the reference's alternative scaling
    (mass 1/ρ, stiffness c²/ρ). The δ term is the nodal apply
    (``SEMOperators.stiffness_apply_nodal``): on a lattice its scales are
    packed once (``pack_scales_nodal``), on the general path the raw nodal
    values [ndofs] are gathered per cell at every apply."""

    STIFF_KEYS = ("coeff_u",)
    NODAL_STIFF_KEYS = ("delta_scales",)
    SHARD_INV_KEYS = ("inv_m",)  # streamed setup: sum local m, then invert

    def __init__(self, mesh, meshtags, degree, c0, rho0, delta0, freq0, p0, s0,
                 sponge_start: float = 0.12, delta_profile=None,
                 dtype=torch.float32, device="cuda"):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, 4, 0.0, dtype, device)
        c0, rho0 = float(np.asarray(c0).mean()), float(np.asarray(rho0).mean())
        lmbda = float(s0) / float(freq0)
        ops = self.ops
        coords = ops.space.dof_coords.T
        if delta_profile is None:
            x0 = coords[0]
            slope = float(delta0) / 5.0 / lmbda
            delta = np.where(x0 < sponge_start, 0.0, slope * (x0 - sponge_start))
        else:
            delta = np.asarray(delta_profile(coords), np.float64)
        self.delta_nodal = delta
        nc = mesh.num_cells
        self.consts = self.base_consts()
        # m = ∫ (1/ρ) u φ dx + ∫_Γ2 (δ(x)/ρc) u φ ds
        m = ops.assemble_diag(np.full(nc, 1.0 / rho0)) + ops.facet_vector_nodal(
            self.ABC_TAG, delta / (rho0 * c0))
        self.consts["inv_m"] = ops.to_device(1.0 / m)
        self.raw_stiff = {"coeff_u": np.full(nc, c0 * c0 / rho0)}
        self.consts["coeff_u"] = ops.stiff_coeff(np.full(nc, c0 * c0 / rho0))
        self.raw_nodal = {"delta_scales": delta / rho0}
        self.consts["delta_scales"] = (
            ops.pack_scales_nodal(delta / rho0) if ops.lattice is not None
            else ops.to_device(delta / rho0))
        self.consts["src_vec"] = ops.to_device(ops.facet_vector(self.SOURCE_TAG, c0 * c0 / rho0))
        self.consts["src_vec_d"] = ops.to_device(
            ops.facet_vector_nodal(self.SOURCE_TAG, delta / rho0))
        self.consts["abc_diag"] = ops.to_device(ops.facet_vector(self.ABC_TAG, c0 / rho0))
        self._build()

    @staticmethod
    def rhs_pure(ops, consts, t, u, v):
        g, dg = source_amplitudes(consts, t)
        b = (
            -ops.stiffness_apply([u], [consts["coeff_u"]])
            - ops.stiffness_apply_nodal([v], [consts["delta_scales"]])
            + g * consts["src_vec"]
            + dg * consts["src_vec_d"]
            - consts["abc_diag"] * v
        )
        return v, b * consts["inv_m"]

    def rk4(self, t0: float, tf: float, dt: float):
        self.dt = float(dt)
        self._build()
        return self.rk(t0, tf)


# --------------------------------------------------------------------------
# Adaptive Dormand-Prince RK5(4) — the analogue of scipy's RK45


_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_DP_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)


def _combine(coefs, ks, like):
    """Σ_j coefs[j]·ks[j], summed from zero in order (the JAX package's
    ``sum(..., zeros_like)``), one in-place pass a nonzero term (a zero
    coefficient adds nothing to finite slopes)."""
    out = torch.zeros_like(like)
    for a, k in zip(coefs, ks):
        if a != 0.0:
            out.add_(k, alpha=float(a))
    return out


def step_factor(err: float) -> float:
    """The step-size factor clip(0.9·err^(-1/5), 0.2, 10) in float64, as the
    JAX package computes it: err = 0 gives err^(-1/5) = inf, so 10."""
    with np.errstate(divide="ignore"):
        return float(np.clip(0.9 * np.float64(err) ** -0.2, 0.2, 10.0))


def adaptive_rk45(rhs, u0, v0, t0, tf, dt0, atol=1e-9, rtol=1e-9, max_steps=1_000_000,
                  log=None):
    """Dormand-Prince 5(4) with PI-free step control (scipy-RK45-style
    tolerances, reference ``_experimental.py:676-712``). ``rhs(t, u, v) ->
    (ku, kv)``. A host loop over attempts: the seven slopes and the error
    norm on the fields' device, then one host read of the norm decides
    accept/reject and the next step, as the JAX ``while_loop`` does; t and
    dt are float64 on the host. ``log``, if given, gets (accepted, err) of
    every attempt. Returns (u, v, t, attempts)."""
    n = u0.numel() + v0.numel()

    def attempt(t, u, v, dt):
        kus, kvs = [], []
        for i in range(7):
            du = _combine(_DP_A[i], kus, u)
            dv = _combine(_DP_A[i], kvs, v)
            ku, kv = rhs(t + _DP_C[i] * dt, u + dt * du, v + dt * dv)
            kus.append(ku)
            kvs.append(kv)
        u5 = u + dt * _combine(_DP_B5, kus, u)
        v5 = v + dt * _combine(_DP_B5, kvs, v)
        eu = dt * _combine(_DP_B5 - _DP_B4, kus, u)
        ev = dt * _combine(_DP_B5 - _DP_B4, kvs, v)
        su = atol + rtol * torch.maximum(u.abs(), u5.abs())
        sv = atol + rtol * torch.maximum(v.abs(), v5.abs())
        err = torch.sqrt((((eu / su) ** 2).sum() + ((ev / sv) ** 2).sum()) / n)
        return u5, v5, err

    t, u, v, dt, steps = float(t0), u0, v0, float(dt0), 0
    while t < tf and steps < max_steps:
        dt_c = min(dt, tf - t)
        u5, v5, err_t = attempt(t, u, v, dt_c)
        err = float(err_t)  # the attempt's one host read
        accept = err <= 1.0
        fac = step_factor(err)
        dt = dt_c * fac if accept else dt_c * float(np.maximum(0.2, fac))
        if accept:
            t, u, v = t + dt_c, u5, v5
        steps += 1
        if log is not None:
            log.append((accept, err))
    return u, v, t, steps


class _AdaptiveRKMixin:
    """Shared adaptive-RK driver over the model's ``rhs_pure``: ``rk``
    marches from the model's state with dt0 = (tf − t0)·1e-4 and sets
    ``nsteps`` (attempts, accepted or not, as the JAX package counts them)
    and ``naccepted``."""

    def adaptive(self, t0: float, tf: float, ops=None, max_steps=1_000_000, log=None):
        """``adaptive_rk45`` from the model's state, which it leaves as it
        is; ``ops`` replaces the model's operators (``ops.plain()`` runs the
        plain stiffness). Returns (u, v, t, attempts)."""
        ops = self.ops if ops is None else ops
        rhs_pure, consts = type(self).rhs_pure, self.consts
        dt0 = 0.01 * (tf - t0) / 100.0
        return adaptive_rk45(lambda t, u, v: rhs_pure(ops, consts, t, u, v),
                             self.u_n, self.v_n, t0, tf, dt0, self.atol, self.rtol,
                             max_steps=max_steps, log=log)

    def rk(self, t0: float, tf: float):
        log = []
        u, v, t, steps = self.adaptive(t0, tf, log=log)
        self.u_n, self.v_n, self.t = u, v, float(t)
        self.nsteps = int(steps)
        self.naccepted = sum(1 for accepted, _ in log if accepted)
        return self.u_n, self.v_n, self.t, self.nsteps


class LinearSpectralAdaptive(_AdaptiveRKMixin, LinearSpectralExplicit):
    """Adaptive-RK linear solver (reference ``LinearSpectralSciPy``,
    ``_experimental.py:543-712``)."""

    def __init__(self, mesh, meshtags, degree, c0, rho0, freq0, p0, s0,
                 dtype=torch.float64, device="cuda", atol=1e-9, rtol=1e-9):
        super().__init__(mesh, meshtags, degree, c0, rho0, freq0, p0, s0,
                         4, 1.0, dtype=dtype, device=device)
        self.atol, self.rtol = atol, rtol


class WesterveltSpectralAdaptive(_AdaptiveRKMixin, WesterveltSpectralExplicit):
    """Adaptive-RK Westervelt solver (reference ``WesterveltSpectralSciPy``,
    ``_experimental.py:987-1188``)."""

    def __init__(self, mesh, meshtags, degree, c0, rho0, delta0, beta0, freq0,
                 p0, s0, dtype=torch.float64, device="cuda", atol=1e-9, rtol=1e-9):
        super().__init__(mesh, meshtags, degree, c0, rho0, delta0, beta0,
                         freq0, p0, s0, 4, 1.0, dtype=dtype, device=device)
        self.atol, self.rtol = atol, rtol


# Reference-name aliases (API parity with the reference package exports)
LinearSpectralSciPy = LinearSpectralAdaptive
WesterveltSpectralSciPy = WesterveltSpectralAdaptive
