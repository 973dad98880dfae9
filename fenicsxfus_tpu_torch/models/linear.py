"""Linear second-order wave equation, explicit RK and SDIRK (port of
``fenicsxfus_tpu/models/linear.py``: ``LinearExplicit``,
``LinearSpectralExplicit`` and ``LinearSpectralImplicit``).

Physics (reference ``python/src/fenicsxfus/_linear.py``):

    (1/ρ0 c0²) ∂²u/∂t² − ∇·(1/ρ0 ∇u) = 0

rewritten first-order in time (u, v = ∂u/∂t), with a windowed transducer
Neumann source g(t) on facet tag 1 and a first-order Sommerfeld ABC
(1/ρ0 c0) ∂u/∂t on facet tag 2. GLL collocation makes the mass diagonal, so
the explicit solver never solves a linear system; the implicit SDIRK
variant solves (M + τ²K + τ·ABC)·kv = b by matrix-free Jacobi-preconditioned
CG (reference ``:623-647``), its matvec one stiffness apply (K1 on a 3D
lattice). ``LinearExplicit`` is the Gauss-quadrature variant: a consistent
mass solved by CG at every slope (``ops/quadrature_ops.py``, torch ops).
"""

from __future__ import annotations

import torch

from ..analysis.timing import span
from ..ops.cg import cg_solve
from ..ops.quadrature_ops import QuadratureOperators
from .base import ExplicitModelBase, ImplicitModelBase, _cellwise, source_amplitudes


class LinearExplicit(ExplicitModelBase):
    """Explicit-RK linear solver with *Gauss* quadrature (reference
    ``_linear.py:12-255``): the mass matrix is consistent (not diagonal), so
    every slope solves M·kv = b, by CG (``ops/cg.py``) on the matrix-free
    ``QuadratureOperators.mass_apply`` preconditioned by the consistent
    mass's diagonal (the reference assembles M and solves by LU). Its data
    are instance attributes (no ``rhs_pure``), so the step is the unfused
    one over ``rhs``. ``cg_log`` gathers the CG iterations of every slope
    since the model was built (or since the caller cleared it)."""

    def __init__(self, mesh, meshtags, degree, c0, rho0, freq0, p0, s0,
                 rk_order, dt, dtype=torch.float64, device="cuda", nq=None,
                 cg_rtol=1e-10, cg_maxiter=500):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, rk_order, dt,
                         dtype, device)
        nc = mesh.num_cells
        c = _cellwise(c0, nc)
        rho = _cellwise(rho0, nc)
        ops = self.ops
        self.qops = QuadratureOperators(ops, nq)
        self.cg_rtol, self.cg_maxiter = cg_rtol, cg_maxiter
        self.cg_log: list[int] = []
        self.consts = self.base_consts()
        self.mass_coeff = ops.to_device(1.0 / (rho * c * c))
        self.stiff_coeff = ops.to_device(1.0 / rho)
        self.mdiag_inv = 1.0 / self.qops.mass_diag(1.0 / (rho * c * c))
        with span("fus.setup.source"):
            self.src_vec = ops.to_device(ops.facet_vector(self.SOURCE_TAG, 1.0 / rho))
        self.abc_diag = ops.to_device(ops.facet_vector(self.ABC_TAG, 1.0 / (rho * c)))
        self._build()

    def rhs(self, t, u, v):
        g, _ = source_amplitudes(self.consts, t)
        b = (
            -self.qops.stiffness_apply([u], [self.stiff_coeff])
            + g * self.src_vec
            - self.abc_diag * v
        )
        kv, (it, _) = cg_solve(
            lambda x: self.qops.mass_apply(x, self.mass_coeff),
            b, b * self.mdiag_inv, self.mdiag_inv,
            rtol=self.cg_rtol, maxiter=self.cg_maxiter,
        )
        self.cg_log.append(it)
        return v, kv


class LinearSpectralExplicit(ExplicitModelBase):
    """Explicit-RK linear wave solver (reference ``_linear.py:258-513``)."""

    STIFF_KEYS = ("coeff_u",)
    FUSED_KIND = "linear"
    SHARD_INV_KEYS = ("inv_m",)  # stored as 1/assembled-diagonal

    def __init__(self, mesh, meshtags, degree, c0, rho0, freq0, p0, s0,
                 rk_order, dt, dtype=torch.float32, device="cuda"):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, rk_order, dt,
                         dtype, device)
        nc = mesh.num_cells
        c = _cellwise(c0, nc)
        rho = _cellwise(rho0, nc)
        ops = self.ops
        self.consts = self.base_consts()
        # LHS lumped mass ∫ (1/ρc²) u φ dx (reference a-form :349-353),
        # assembled and inverted on the host
        self.consts["inv_m"] = ops.to_device(1.0 / ops.assemble_diag(1.0 / (rho * c * c)))
        # RHS pieces (reference L-form :355-361); the raw DG-0 coefficient
        # (float64, host) is what the slab decomposition packs per rank
        self.raw_stiff = {"coeff_u": 1.0 / rho}
        self.consts["coeff_u"] = ops.stiff_coeff(1.0 / rho)
        with span("fus.setup.source"):
            self.consts["src_vec"] = ops.to_device(ops.facet_vector(self.SOURCE_TAG, 1.0 / rho))
        self.consts["abc_diag"] = ops.to_device(ops.facet_vector(self.ABC_TAG, 1.0 / (rho * c)))
        self._build()

    @staticmethod
    def rhs_pure(ops, consts, t, u, v):
        g, _ = source_amplitudes(consts, t)
        b = (
            -ops.stiffness_apply([u], [consts["coeff_u"]])
            + g * consts["src_vec"]
            - consts["abc_diag"] * v
        )
        return v, b * consts["inv_m"]

    def energy(self, u=None, v=None) -> float:
        """Discrete acoustic energy ½ vᵀMv + ½ uᵀKu of (u, v) (default: the
        current state), M the lumped 1/ρc² mass and K the 1/ρ stiffness,
        summed in float64."""
        u = self.u_n if u is None else u
        v = self.v_n if v is None else v
        ku = self.ops.stiffness_apply([u], [self.consts["coeff_u"]])
        kin = (v.double() ** 2 / self.consts["inv_m"].double()).sum()
        pot = (u.double() * ku.double()).sum()
        return float(0.5 * (kin + pot))


class LinearSpectralImplicit(ImplicitModelBase):
    """SDIRK linear wave solver (reference ``_linear.py:516-817``)."""

    STIFF_KEYS = ("coeff_u",)
    PAD_ONE_KEYS = ("m",)  # inverted inside the solver: padding must stay finite

    def __init__(self, mesh, meshtags, degree, c0, rho0, freq0, p0, s0,
                 rk_order, dt, dtype=torch.float64, device="cuda", cg_rtol=1e-8,
                 cg_maxiter=2000):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, rk_order, dt,
                         dtype, device, cg_rtol, cg_maxiter)
        nc = mesh.num_cells
        c = _cellwise(c0, nc)
        rho = _cellwise(rho0, nc)
        ops = self.ops
        self.consts = self.base_consts()
        self.consts["m"] = ops.to_device(ops.assemble_diag(1.0 / (rho * c * c)))
        self.raw_stiff = {"coeff_u": 1.0 / rho}
        self.consts["coeff_u"] = ops.stiff_coeff(1.0 / rho)
        self.consts["kdiag"] = ops.stiffness_diag(1.0 / rho)
        with span("fus.setup.source"):
            self.consts["src_vec"] = ops.to_device(ops.facet_vector(self.SOURCE_TAG, 1.0 / rho))
        self.consts["abc_diag"] = ops.to_device(ops.facet_vector(self.ABC_TAG, 1.0 / (rho * c)))

    @staticmethod
    def lhs_pure(ops, c, tau, x):
        """A x = M x + τ² K x + τ ABC x  (reference a-form :623-631)."""
        return (
            c["m"] * x
            + tau * tau * ops.stiffness_apply([x], [c["coeff_u"]])
            + tau * c["abc_diag"] * x
        )

    @staticmethod
    def lhs_diag_pure(ops, c, tau):
        return c["m"] + tau * tau * c["kdiag"] + tau * c["abc_diag"]

    @staticmethod
    def rhs_stage(ops, c, tau, t, u, v):
        """b = −K(u + τ v) + g·src − ABC·v  (reference L-form :633-639)."""
        g, _ = source_amplitudes(c, t)
        return (
            -ops.stiffness_apply([u + tau * v], [c["coeff_u"]])
            + g * c["src_vec"]
            - c["abc_diag"] * v
        )
