"""Westervelt nonlinear acoustics, explicit RK (port of
``fenicsxfus_tpu/models/westervelt.py::WesterveltSpectralExplicit``).

Physics (reference ``python/src/fenicsxfus/_westervelt.py``): the lossy wave
equation plus the 2β/(ρ²c⁴)·u·u_tt nonlinearity, which makes the lumped mass
depend on the solution; the reference reassembles it every RK stage
(``:230-234``). With GLL collocation it stays diagonal:

    m(u) = m0 − d2 ∘ u,     d2 = assembled diag of 2β/(ρ²c⁴)

and the nonlinear right-hand-side term +∫ 2β/(ρ²c⁴) v² φ dx is d2 ∘ v².
"""

from __future__ import annotations

import torch

from ..analysis.timing import span
from .base import ExplicitModelBase, _cellwise, source_amplitudes


class WesterveltSpectralExplicit(ExplicitModelBase):
    """Explicit-RK Westervelt solver (reference ``_westervelt.py:12-329``)."""

    STIFF_KEYS = ("coeff_u", "coeff_v")
    FUSED_KIND = "westervelt"
    # sharded uneven partitions divide by m = m0 − d2∘u on padding rows too
    PAD_ONE_KEYS = ("m0",)

    def __init__(self, mesh, meshtags, degree, c0, rho0, delta0, beta0, freq0,
                 p0, s0, rk_order, dt, dtype=torch.float32, device="cuda"):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, rk_order, dt,
                         dtype, device)
        nc = mesh.num_cells
        c = _cellwise(c0, nc)
        rho = _cellwise(rho0, nc)
        delta = _cellwise(delta0, nc)
        beta = _cellwise(beta0, nc)
        ops = self.ops
        self.consts = self.base_consts()
        # solution-independent lumped mass (reference a-form :108-128)
        self.consts["m0"] = ops.to_device(
            ops.assemble_diag(1.0 / (rho * c * c))
            + ops.facet_vector(self.ABC_TAG, delta / (rho * c**3))
        )
        # nonlinear diagonal 2β/(ρ²c⁴)
        self.consts["d2"] = ops.to_device(ops.assemble_diag(2.0 * beta / (rho * rho * c**4)))
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
        # per-stage nonlinear lumped mass (reference f1 LHS reassembly :230-234)
        m = consts["m0"] - consts["d2"] * u
        b = (
            -ops.stiffness_apply([u, v], [consts["coeff_u"], consts["coeff_v"]])
            + g * consts["src_vec"]
            + dg * consts["src_vec_d"]
            - consts["abc_diag"] * v
            + consts["d2"] * (v * v)
        )
        return v, b / m
