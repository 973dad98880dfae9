"""Lossy (viscoelastic) wave equation, explicit RK and SDIRK (port of
``fenicsxfus_tpu/models/lossy.py::LossySpectralExplicit`` and
``LossySpectralImplicit``).

Physics (reference ``python/src/fenicsxfus/_lossy.py``): the linear wave
equation plus a diffusivity-of-sound term δ ∇²(∂u/∂t):

    (1/ρ0 c0²) u_tt − ∇·(1/ρ0 ∇u) − (δ0/ρ0 c0²) ∇²(u_t) = 0

Weak-form additions to the linear model (reference a/L-forms ``:107-128``):
the lumped mass gains the facet term ∫_Γ2 (δ/ρc³) u φ ds, the right-hand
side gains −∫ (δ/ρc²) ∇v·∇φ dx and the source derivative ∫_Γ1 (δ/ρc²) dg φ ds.
Both stiffness terms go through one two-field stiffness apply (K1 with two
fields on a 3D lattice), in the explicit slope and in the implicit model's
CG matvec and stage right-hand side alike.
"""

from __future__ import annotations

import torch

from ..analysis.timing import span
from .base import ExplicitModelBase, ImplicitModelBase, _cellwise, source_amplitudes


class LossySpectralExplicit(ExplicitModelBase):
    """Explicit-RK lossy solver (reference ``_lossy.py:12-294``)."""

    STIFF_KEYS = ("coeff_u", "coeff_v")
    FUSED_KIND = "lossy"
    SHARD_INV_KEYS = ("inv_m",)

    def __init__(self, mesh, meshtags, degree, c0, rho0, delta0, freq0, p0, s0,
                 rk_order, dt, dtype=torch.float32, device="cuda"):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, rk_order, dt,
                         dtype, device)
        nc = mesh.num_cells
        c = _cellwise(c0, nc)
        rho = _cellwise(rho0, nc)
        delta = _cellwise(delta0, nc)
        ops = self.ops
        self.consts = self.base_consts()
        # LHS: volume mass + δ-ABC facet mass (reference a-form :107-115)
        self.consts["inv_m"] = ops.to_device(1.0 / (
            ops.assemble_diag(1.0 / (rho * c * c))
            + ops.facet_vector(self.ABC_TAG, delta / (rho * c**3))
        ))
        self.raw_stiff = {"coeff_u": 1.0 / rho, "coeff_v": delta / (rho * c * c)}
        self.consts["coeff_u"] = ops.stiff_coeff(1.0 / rho)
        self.consts["coeff_v"] = ops.stiff_coeff(delta / (rho * c * c))
        with span("fus.setup.source"):
            self.consts["src_vec"] = ops.to_device(ops.facet_vector(self.SOURCE_TAG, 1.0 / rho))
            self.consts["src_vec_d"] = ops.to_device(
                ops.facet_vector(self.SOURCE_TAG, delta / (rho * c * c))
            )
        self.consts["abc_diag"] = ops.to_device(ops.facet_vector(self.ABC_TAG, 1.0 / (rho * c)))
        self._build()

    @staticmethod
    def rhs_pure(ops, consts, t, u, v):
        g, dg = source_amplitudes(consts, t)
        b = (
            -ops.stiffness_apply([u, v], [consts["coeff_u"], consts["coeff_v"]])
            + g * consts["src_vec"]
            + dg * consts["src_vec_d"]
            - consts["abc_diag"] * v
        )
        return v, b * consts["inv_m"]


class LossySpectralImplicit(ImplicitModelBase):
    """SDIRK lossy solver (reference ``_lossy.py:297-628``)."""

    STIFF_KEYS = ("coeff_u", "coeff_v")
    PAD_ONE_KEYS = ("m",)

    def __init__(self, mesh, meshtags, degree, c0, rho0, delta0, freq0, p0, s0,
                 rk_order, dt, dtype=torch.float64, device="cuda", cg_rtol=1e-8,
                 cg_maxiter=2000):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, rk_order, dt,
                         dtype, device, cg_rtol, cg_maxiter)
        nc = mesh.num_cells
        c = _cellwise(c0, nc)
        rho = _cellwise(rho0, nc)
        delta = _cellwise(delta0, nc)
        ops = self.ops
        self.consts = self.base_consts()
        self.consts["m"] = ops.to_device(
            ops.assemble_diag(1.0 / (rho * c * c))
            + ops.facet_vector(self.ABC_TAG, delta / (rho * c**3))
        )
        self.raw_stiff = {"coeff_u": 1.0 / rho, "coeff_v": delta / (rho * c * c)}
        self.consts["coeff_u"] = ops.stiff_coeff(1.0 / rho)
        self.consts["coeff_v"] = ops.stiff_coeff(delta / (rho * c * c))
        self.consts["kdiag_u"] = ops.stiffness_diag(1.0 / rho)
        self.consts["kdiag_v"] = ops.stiffness_diag(delta / (rho * c * c))
        with span("fus.setup.source"):
            self.consts["src_vec"] = ops.to_device(ops.facet_vector(self.SOURCE_TAG, 1.0 / rho))
            self.consts["src_vec_d"] = ops.to_device(
                ops.facet_vector(self.SOURCE_TAG, delta / (rho * c * c))
            )
        self.consts["abc_diag"] = ops.to_device(ops.facet_vector(self.ABC_TAG, 1.0 / (rho * c)))

    @staticmethod
    def lhs_pure(ops, c, tau, x):
        """A x = M x + τ²K_{1/ρ} x + τK_{δ/ρc²} x + τ ABC x
        (reference a-form ``_lossy.py:410-427``)."""
        return (
            c["m"] * x
            + ops.stiffness_apply([tau * tau * x, tau * x], [c["coeff_u"], c["coeff_v"]])
            + tau * c["abc_diag"] * x
        )

    @staticmethod
    def lhs_diag_pure(ops, c, tau):
        return (
            c["m"]
            + tau * tau * c["kdiag_u"]
            + tau * c["kdiag_v"]
            + tau * c["abc_diag"]
        )

    @staticmethod
    def rhs_stage(ops, c, tau, t, u, v):
        """b = −K_{1/ρ}(u + τ v) − K_{δ/ρc²}(v) + g·src + dg·srcδ − ABC·v
        (reference L-form ``_lossy.py:429-445``)."""
        g, dg = source_amplitudes(c, t)
        return (
            -ops.stiffness_apply([u + tau * v, v], [c["coeff_u"], c["coeff_v"]])
            + g * c["src_vec"]
            + dg * c["src_vec_d"]
            - c["abc_diag"] * v
        )
