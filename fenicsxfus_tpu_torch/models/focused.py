"""Focused (bowl) transducer sources via a phased flat aperture (port of
``fenicsxfus_tpu/models/focused.py``).

The reference's HITU benchmarks (H101/H131 bowls, Groth et al. 2021;
``cpp/fenicsx-sf-fastor/benchmarks/HITU/*``) mesh the curved bowl surface
and drive it through facet tags. On a structured box the equivalent is a
*phased, obliquity-weighted* flat aperture in the bowl's rim plane: exact-focus
emission delays plus the spherical-cap surface measure 1/cosθ (see
``bowl_delays``), validated against the O'Neil (1949) axial solution
(``drivers/hitu.py::validate_oneil``). Because

    cos(ω(t − τ(x))) = cos(ωτ(x))·cos(ωt) + sin(ωτ(x))·sin(ωt)

the spatially varying phase splits into two static facet vectors weighted by
time-dependent scalars, and the fused stage (K2 kind ``focused``) carries
them as packed boundary planes.

``focal_distance`` throughout is the bowl's radius of curvature (the
manufacturer's "focal length"); the geometric focus then sits at
√(roc² − a²) from the aperture plane.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..analysis.timing import span
from .base import ExplicitModelBase, _cellwise
from .common import source_window


def bowl_delays(coords, center, aperture_radius, roc, c0, axis=0, obliquity=True):
    """(weighted mask s(x), delay τ(x)) for a flat phased aperture standing
    in for a spherical-cap bowl of radius of curvature ``roc`` and rim radius
    ``aperture_radius``; ``coords`` [dim, n].

    The aperture plane is the bowl's rim plane, so the geometric focus lies
    at depth F = √(roc² − a²) from it. Delays are the exact planar focusing
    law τ(r) = (roc − √(F²+r²))/c (simultaneous arrival at F, as on the bowl
    surface). With ``obliquity`` the amplitude carries the spherical-cap
    surface-measure factor roc/√(roc²−r²) = 1/cosθ, the Rayleigh-integral
    weight that makes the planar source radiate the same ∫ vₙ dS as the
    curved bowl (O'Neil 1949)."""
    d = coords.shape[0]
    r2 = np.zeros(coords.shape[1])
    for a in range(d):
        if a == axis:
            continue
        r2 += (coords[a] - center[a]) ** 2
    r = np.sqrt(r2)
    inside = r <= aperture_radius
    mask = inside.astype(np.float64)
    tau = (roc - np.sqrt(roc**2 - aperture_radius**2 + r2)) / c0
    if obliquity:
        under = np.maximum(roc**2 - r2, roc**2 - aperture_radius**2)
        mask = mask * (roc / np.sqrt(under))
    return mask, tau * inside


class WesterveltSpectralFocused(ExplicitModelBase):
    """Westervelt solver with a phased (focused) source, the HITU bowl
    analogue. With β = δ = 0 it reduces to a focused linear solver."""

    STIFF_KEYS = ("coeff_u", "coeff_v")
    PAD_ONE_KEYS = ("m0",)
    FUSED_KIND = "focused"

    def __init__(self, mesh, meshtags, degree, c0, rho0, delta0, beta0, freq0,
                 p0, s0, rk_order, dt, aperture_radius, focal_distance,
                 center=None, dtype=torch.float32, device="cuda"):
        super().__init__(mesh, meshtags, degree, freq0, p0, s0, rk_order, dt,
                         dtype, device)
        nc = mesh.num_cells
        c = _cellwise(c0, nc)
        rho = _cellwise(rho0, nc)
        delta = _cellwise(delta0, nc)
        beta = _cellwise(beta0, nc)
        ops = self.ops
        self.consts = self.base_consts()
        self.consts["m0"] = ops.to_device(
            ops.assemble_diag(1.0 / (rho * c * c))
            + ops.facet_vector(self.ABC_TAG, delta / (rho * c**3))
        )
        self.consts["d2"] = ops.to_device(ops.assemble_diag(2.0 * beta / (rho * rho * c**4)))
        self.raw_stiff = {"coeff_u": 1.0 / rho, "coeff_v": delta / (rho * c * c)}
        self.consts["coeff_u"] = ops.stiff_coeff(1.0 / rho)
        self.consts["coeff_v"] = ops.stiff_coeff(delta / (rho * c * c))
        self.consts["abc_diag"] = ops.to_device(ops.facet_vector(self.ABC_TAG, 1.0 / (rho * c)))

        with span("fus.setup.source"):
            coords = ops.dof_coords().T
            lo = mesh.vertices.min(axis=0)
            hi = mesh.vertices.max(axis=0)
            if center is None:
                center = (hi + lo) / 2.0
            # delays use the wave speed of the cells adjacent to the aperture
            # (the fluid the bowl sits in), not a global mean
            src_cells = ops.facet_data(self.SOURCE_TAG)[2]
            c_src = float(np.mean(c[src_cells])) if len(src_cells) else float(np.mean(c))
            mask, tau = bowl_delays(coords, center, aperture_radius, focal_distance, c_src)
            w0 = self.w0
            # phase-split facet vectors with per-cell material coefficients
            # (1/ρ and δ/ρc²; the reference keeps these DG-0 inside the facet
            # forms, _lossy.py:107-128)
            for name, coeff in [("", 1.0 / rho), ("_d", delta / (rho * c * c))]:
                self.consts[f"src_cos{name}"] = ops.to_device(ops.facet_vector_nodal(
                    self.SOURCE_TAG, mask * np.cos(w0 * tau), cell_coeff=coeff
                ))
                self.consts[f"src_sin{name}"] = ops.to_device(ops.facet_vector_nodal(
                    self.SOURCE_TAG, mask * np.sin(w0 * tau), cell_coeff=coeff
                ))
        self._build()

    @staticmethod
    def rhs_pure(ops, consts, t, u, v):
        w0 = consts["w0"]
        amp = consts["p0"] * w0 / consts["s0"]
        win, dwin = source_window(t, consts["freq"], consts["alpha"])
        cos_t, sin_t = math.cos(w0 * t), math.sin(w0 * t)
        # g(x,t)  = win·amp·(cosτ·cos + sinτ·sin)
        # dg(x,t) = dwin·amp·(…) + win·amp·w0·(−cosτ·sin + sinτ·cos)
        g_vec = (win * amp) * (cos_t * consts["src_cos"] + sin_t * consts["src_sin"])
        dg_vec = (dwin * amp) * (
            cos_t * consts["src_cos_d"] + sin_t * consts["src_sin_d"]
        ) + (win * amp * w0) * (-sin_t * consts["src_cos_d"] + cos_t * consts["src_sin_d"])
        m = consts["m0"] - consts["d2"] * u
        b = (
            -ops.stiffness_apply([u, v], [consts["coeff_u"], consts["coeff_v"]])
            + g_vec
            + dg_vec
            - consts["abc_diag"] * v
            + consts["d2"] * (v * v)
        )
        return v, b / m
