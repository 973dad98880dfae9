"""Lossy (viscoelastic) wave equation, explicit RK (port of
``fenicsxfus_tpu/models/lossy.py::LossySpectralExplicit``).

Physics (reference ``python/src/fenicsxfus/_lossy.py``): the linear wave
equation plus a diffusivity-of-sound term δ ∇²(∂u/∂t):

    (1/ρ0 c0²) u_tt − ∇·(1/ρ0 ∇u) − (δ0/ρ0 c0²) ∇²(u_t) = 0

Weak-form additions to the linear model (reference a/L-forms ``:107-128``):
the lumped mass gains the facet term ∫_Γ2 (δ/ρc³) u φ ds, the right-hand
side gains −∫ (δ/ρc²) ∇v·∇φ dx and the source derivative ∫_Γ1 (δ/ρc²) dg φ ds.
Both stiffness terms go through one two-field stiffness apply.
"""

from __future__ import annotations

import torch

from .base import ExplicitModelBase, _cellwise, source_amplitudes


class LossySpectralExplicit(ExplicitModelBase):
    """Explicit-RK lossy solver (reference ``_lossy.py:12-294``)."""

    STIFF_KEYS = ("coeff_u", "coeff_v")
    FUSED_KIND = "lossy"

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
        self.consts["coeff_u"] = ops.stiff_coeff(1.0 / rho)
        self.consts["coeff_v"] = ops.stiff_coeff(delta / (rho * c * c))
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
