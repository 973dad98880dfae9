"""Analytical solutions used as correctness oracles (numpy).

Copied from ``fenicsxfus_tpu/analysis/analytical.py``:

* plane wave driven from a boundary (reference ``python/tests/test_linearspectral_1d.py:76-93``),
* exponentially damped plane wave (``test_lossyspectral_1d.py:85-105``),
* Fubini-Bessel series for the lossless Westervelt shock steepening
  (``test_westerveltspectral_1d.py:86-110``),
* Mendousse solution for nonlinear + thermoviscous propagation
  (``python/benchmarks/MENDOUSSE/mendousse.py``),
* the axial amplitude of a baffled piston (the PH1 SC1 oracle) and of a
  focused spherical cap (O'Neil, the HITU bowl oracle),
* 2D cylinder scattering series (``python/src/fenicsxfus/_analytical.py``).
"""

from __future__ import annotations

import numpy as np
from scipy.special import hankel1, iv, jv


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


def piston_axial_amplitude(z, a, k, p0):
    """Steady-state axial pressure amplitude of a baffled circular piston
    (radius ``a``, wavenumber ``k``, plane-wave drive amplitude ``p0``):

        |p(z)| = 2 p0 |sin(k(sqrt(z^2 + a^2) - z)/2)|

    Oracle for the PH1 SC1 benchmarks (Aubry et al. 2022, planar 20 mm
    source; reference driver ``cpp/fenicsx-sf-naive/benchmarks/PH1/
    SC1-BM1/main.cpp:32-45``)."""
    z = np.asarray(z, np.float64)
    return 2.0 * p0 * np.abs(np.sin(0.5 * k * (np.sqrt(z * z + a * a) - z)))


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


class SoundHardExact2D:
    """Scattering of a plane wave by a sound-hard circular cylinder
    (Neumann), Bessel/Hankel partial-wave series; total field is zero inside
    the scatterer. Reference ``_analytical.py:5-60``."""

    def __init__(self, t, angular_freq, wavenumber, scat_rad):
        self.t = t
        self.w0 = angular_freq
        self.k = wavenumber
        self.a = scat_rad
        self.f = 0.0
        self.nterms = int(30 + (self.k * self.a) ** 1.01)

    def incident(self, x):
        r = np.hypot(x[0], x[1])
        ui = np.exp(1j * self.k * x[0])
        ui[r < self.a] = 0
        return ui

    def scatter(self, x):
        k, a = self.k, self.a
        r = np.hypot(x[0], x[1])
        th = np.arctan2(x[1], x[0])
        us = np.zeros_like(r, dtype=complex)
        for n in range(-self.nterms, self.nterms):
            # d/dr of J_n, H_n at the cylinder surface
            dj = jv(n - 1, k * a) - n / (k * a) * jv(n, k * a)
            dh = n / (k * a) * hankel1(n, k * a) - hankel1(n + 1, k * a)
            us += -(1j**n) * dj / dh * hankel1(n, k * r) * np.exp(1j * n * th)
        us[r < self.a] = 0
        return us

    def total(self, x):
        self.f = self.incident(x) + self.scatter(x)
        return self.f

    def total_time_dependent(self, x):
        return np.exp(-1j * self.w0 * self.t) * self.f


class SoundSoftExact2D(SoundHardExact2D):
    """Sound-soft (Dirichlet) cylinder. Reference ``_analytical.py:63-115``."""

    def scatter(self, x):
        k, a = self.k, self.a
        r = np.hypot(x[0], x[1])
        th = np.arctan2(x[1], x[0])
        us = np.zeros_like(r, dtype=complex)
        for n in range(-self.nterms, self.nterms):
            us += (
                -(1j**n)
                * jv(n, k * a)
                / hankel1(n, k * a)
                * hankel1(n, k * r)
                * np.exp(1j * n * th)
            )
        us[r < self.a] = 0
        return us


class PenetrableExact2D:
    """Plane wave hitting a penetrable (different c, ρ) circular cylinder —
    interior + exterior partial-wave expansion with continuity of pressure
    and normal velocity. Reference ``_analytical.py:118-190``."""

    def __init__(self, t, angular_freq, rho_outer, rho_inner, c_outer, c_inner, scat_rad):
        self.t = t
        self.w0 = angular_freq
        self.rho0, self.rho1 = rho_outer, rho_inner
        self.c0, self.c1 = c_outer, c_inner
        self.k0 = angular_freq / c_outer
        self.k1 = angular_freq / c_inner
        self.a = scat_rad
        self.f = 0.0
        self.nterms = int(30 + (self.k0 * self.a) ** 1.01)

    def _coeffs(self, n):
        k0, k1, a = self.k0, self.k1, self.a
        z0, z1 = self.rho0 * self.c0, self.rho1 * self.c1
        djn0 = 0.5 * (jv(n - 1, k0 * a) - jv(n + 1, k0 * a))
        djn1 = 0.5 * (jv(n - 1, k1 * a) - jv(n + 1, k1 * a))
        dhn0 = 0.5 * (hankel1(n - 1, k0 * a) - hankel1(n + 1, k0 * a))
        # Continuity: p and (1/ρc) dp/d(kr): A·H_n(k0 a) − B·J_n(k1 a) = −J_n(k0 a)
        M = np.array(
            [
                [hankel1(n, k0 * a), -jv(n, k1 * a)],
                [dhn0 / z0, -djn1 / z1],
            ]
        )
        rhs = -np.array([jv(n, k0 * a), djn0 / z0])
        A, B = np.linalg.solve(M, rhs)
        return A, B

    def total(self, x):
        r = np.hypot(x[0], x[1])
        th = np.arctan2(x[1], x[0])
        out = np.zeros_like(r, dtype=complex)
        inside = r < self.a
        for n in range(-self.nterms, self.nterms):
            A, B = self._coeffs(n)
            cn = (1j**n) * np.exp(1j * n * th)
            ext = (jv(n, self.k0 * r) + A * hankel1(n, self.k0 * r)) * cn
            inn = B * jv(n, self.k1 * r) * cn
            out += np.where(inside, inn, ext)
        self.f = out
        return out

    def total_time_dependent(self, x):
        return np.exp(-1j * self.w0 * self.t) * self.f
