"""Analytical solutions used as correctness oracles (numpy).

Copied from ``fenicsxfus_tpu/analysis/analytical.py``:

* plane wave driven from a boundary (reference ``python/tests/test_linearspectral_1d.py:76-93``),
* exponentially damped plane wave (``test_lossyspectral_1d.py:85-105``),
* Fubini-Bessel series for the lossless Westervelt shock steepening
  (``test_westerveltspectral_1d.py:86-110``),
* Mendousse solution for nonlinear + thermoviscous propagation
  (``python/benchmarks/MENDOUSSE/mendousse.py``),
* O'Neil axial amplitude of a focused spherical cap (the HITU bowl oracle).

The 2D scattering series arrive with the 2D meshes.
"""

from __future__ import annotations

import numpy as np
from scipy.special import iv, jv


def planewave(x, t, c0, f0, p0):
    """u(x,t) = p0 sin(w0 (t − x/c0)) H(t − x/c0)."""
    w0 = 2 * np.pi * f0
    tau = t - x / c0
    return p0 * np.sin(w0 * tau) * np.heaviside(tau, 0)


def damped_planewave(x, t, c0, f0, p0, alpha_np):
    """Im[p0 exp(i(w0 t − k x)) exp(−α x)] — lossy CW steady state."""
    w0 = 2 * np.pi * f0
    val = p0 * np.exp(1j * (w0 * t - w0 / c0 * x)) * np.exp(-alpha_np * x)
    return val.imag


def fubini(x, t, c0, f0, p0, rho0, beta, nterms=50, eps=1e-7):
    """Fubini series: pre-shock solution of the lossless Burgers equation,
    u/p0 = Σ_n (2/(n σ)) J_n(n σ) sin(n w0 (t − x/c0)), σ = x/x_sh."""
    w0 = 2 * np.pi * f0
    u0 = p0 / rho0 / c0
    xsh = c0**2 / (w0 * beta * u0)
    sigma = (x + eps) / xsh
    val = np.zeros_like(np.broadcast_arrays(x, t)[0], dtype=float)
    for n in range(1, nterms):
        val = val + 2.0 / (n * sigma) * jv(n, n * sigma) * np.sin(
            n * w0 * (t - x / c0)
        )
    return p0 * val


def mendousse(x, t, c0, f0, p0, rho0, beta, delta, nterms=30):
    """Mendousse's exact Fourier solution of the Burgers equation with both
    nonlinearity and thermoviscous absorption (ratio of modified-Bessel
    series). Gol'dberg number Γ = beta p0 / (rho0 c0 delta' w0) form; see
    Hamilton & Blackstock, Nonlinear Acoustics, eq. (4-4-14)."""
    w0 = 2 * np.pi * f0
    u0 = p0 / (rho0 * c0)
    xsh = c0**2 / (w0 * beta * u0)  # shock formation distance
    alpha = delta * w0**2 / (2 * c0**3)  # thermoviscous attenuation
    gamma = 1.0 / (alpha * xsh)  # Gol'dberg number
    sigma = x / xsh
    tau = w0 * (t - x / c0)
    num = np.zeros_like(np.broadcast_arrays(x, t)[0], dtype=float)
    den = np.full_like(num, iv(0, gamma / 2.0))
    for n in range(1, nterms):
        In = iv(n, gamma / 2.0)
        e = np.exp(-(n**2) * sigma / gamma)
        num = num + (-1) ** (n + 1) * n * In * e * np.sin(n * tau)
        den = den + 2.0 * (-1) ** n * In * e * np.cos(n * tau)
    return p0 * (4.0 / gamma) * num / den


def oneil_axial_amplitude(z, a, roc, k, p0):
    """O'Neil (1949) axial pressure amplitude of a focused spherical-cap
    radiator: half-aperture ``a``, radius of curvature ``roc`` (geometric
    focus at z = roc), uniform normal velocity with plane-wave amplitude
    ``p0`` = rho c u0:

        |p(z)| = 2 p0 |sin(k (r_e(z) - z)/2)| / |1 - z/roc|,
        r_e(z) = sqrt((z - h)^2 + a^2),   h = roc - sqrt(roc^2 - a^2)

    (distance from the bowl rim to the axial point). The removable
    singularity at the focus evaluates to p0 k a^2/(2 h ... ) via the limit;
    here the quotient is formed with a small-denominator guard. Oracle for
    PH1 SC2 / HITU bowl sources (reference ``cpp/fenicsx-sf-fastor/
    benchmarks/HITU/W-H101-WATER/main.cpp:1-5``, Groth et al. 2021)."""
    z = np.asarray(z, np.float64)
    h = roc - np.sqrt(roc * roc - a * a)
    r_e = np.sqrt((z - h) ** 2 + a * a)
    phase = 0.5 * k * (r_e - z)
    denom = 1.0 - z / roc
    small = np.abs(denom) < 1e-9
    denom = np.where(small, 1.0, denom)
    amp = 2.0 * p0 * np.abs(np.sin(phase)) / np.abs(denom)
    # limit z -> roc: 2 sin(k(r_e - z)/2)/(1 - z/roc) -> k roc (1 - (roc-h)/r_e(roc))·...
    if np.any(small):
        eps = 1e-6 * roc
        amp_lim = oneil_axial_amplitude(roc - eps, a, roc, k, p0)
        amp = np.where(small, amp_lim, amp)
    return amp
