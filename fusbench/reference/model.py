"""The plain reference of a cell: its mesh, media, source and the explicit
RK4 march of the Westervelt equation, worked out from the configuration
and traffic files alone (nothing of the measured package is imported).

Physics (Westervelt with a lumped, solution-dependent mass): with DG-0
media c, rho, delta (diffusivity of sound) and beta,

    m(u) u_tt = -K_{1/rho} u - K_{delta/(rho c^2)} u_t + g + dg
                - (1/(rho c)) u_t on the absorbing faces + d2 u_t^2,
    m(u) = m0 - d2 u,  m0 = M_{1/(rho c^2)} + F_{delta/(rho c^3)} (absorbing),
    d2 = M_{2 beta/(rho^2 c^4)},

M the lumped mass and F the lumped boundary mass. The source is a
continuous wave cos(w0 t) under a cosine ramp of ``source_ramp_periods``
periods, on facet tag 1: either the curved bowl's facets driven uniformly
(``"source": "facets"``), or a flat aperture phased to focus like the bowl,
each node delayed by tau(r) = (roc - sqrt(roc^2 - a^2 + r^2)) / c and
weighted by the spherical cap's surface measure roc / sqrt(roc^2 - r^2)
(``"source": "phased"``). The march is classical RK4 with each step's start
time on the host in float64 and the sensors read after every step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .bowl_mesh import create_bowl_box
from .geometry import bowl_readings
from .mesh import create_box, tag_boundaries
from .sem import Discretisation

RK4_A = (0.0, 0.5, 0.5, 1.0)
RK4_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)
RK4_C = (0.0, 0.5, 0.5, 1.0)


def diffusivity(omega: float, c, att_db) -> np.ndarray:
    """delta = 2 alpha c^3 / omega^2 with alpha the attenuation in Np/m."""
    alpha = np.asarray(att_db, np.float64) / 20.0 * math.log(10.0)
    return 2.0 * alpha * np.asarray(c, np.float64) ** 3 / omega**2


def step_sizes(t0: float, tf: float, dt: float) -> np.ndarray:
    """The steps from t0 to tf: whole steps of dt, then the remainder if it
    is more than rounding."""
    span = tf - t0
    n = int(np.floor(span / dt + 1e-12))
    rem = span - n * dt
    dts = [dt] * n
    if rem > 1e-12 * max(abs(span), 1.0):
        dts.append(rem)
    return np.array(dts if dts else [0.0])


def ramp(t: float, f0: float, periods: float) -> tuple[float, float]:
    """The cosine ramp over ``periods`` source periods and its derivative."""
    if t < periods / f0:
        arg = f0 * math.pi * t / periods
        return 0.5 * (1.0 - math.cos(arg)), 0.5 * math.pi * f0 / periods * math.sin(arg)
    return 1.0, 0.0


def steps_per_period(config: dict, traffic: dict, h: float, cmax: float) -> int:
    """The CFL rule rounded to whole steps a period:
    int(T / (cfl h / (cmax p^2))) + 1."""
    p = traffic.get("degree", config.get("degree"))
    return int(1.0 / config["f0"] / (traffic["cfl"] * h / (cmax * p**2))) + 1


def build_mesh(config: dict, traffic: dict):
    """The cell's mesh with facet tag 1 (source) and 2 (absorbing)."""
    L, W = config["domain"]["L"], config["domain"]["W"]
    nx = config["nx"]
    h = L / nx
    nyz = max(int(round(W / h)), 2)
    lo, hi = (0.0, -W / 2, -W / 2), (L, W / 2, W / 2)
    a, roc = config["transducer"]["aperture_radius"], config["transducer"]["roc"]
    if traffic["mesh"] == "bowl":
        sag = roc - math.sqrt(roc**2 - a**2)
        blend = traffic["blend_sagittae"] * sag
        mesh, _ = create_bowl_box((nx, nyz, nyz), lo, hi, roc, a, blend=blend,
                                  lateral_hold=traffic["hold_blends"] * blend)
        return mesh, h
    mesh = create_box((nx, nyz, nyz), lo, hi)
    eps = 1e-9

    def src(x):
        return (x[0] < eps) & (np.hypot(x[1], x[2]) <= a)

    if config["absorbing"] == "all_other_faces":
        tag_boundaries(mesh, {1: src}, default=2)
    else:  # the five outer faces; the rest of the source plane is rigid
        def outer(x):
            return (x[0] > L - eps) | (np.abs(x[1]) > W / 2 - eps) | (np.abs(x[2]) > W / 2 - eps)

        tag_boundaries(mesh, {1: src, 2: outer})
    return mesh, h


def build_media(config: dict, traffic: dict, mesh) -> dict:
    """Per-cell c, rho, delta, beta from the configuration's medium or
    materials and the traffic's layers (each cell by its vertices' mean)."""
    nc = mesh.cells.shape[0]
    omega = 2 * math.pi * config["f0"]
    if "medium" in config:
        m = config["medium"]
        c, rho, att = (np.full(nc, float(m[k])) for k in ("c0", "rho0", "att_dB"))
        beta = np.full(nc, float(m["beta"]))
    else:
        mats = config["materials"]
        c, rho, att = (np.full(nc, float(mats[traffic["background"]][i])) for i in range(3))
        beta = np.full(nc, float(config["beta"]))
        cents = mesh.vertices[mesh.cells].mean(axis=1)
        layers = traffic.get("layers", [])
        if layers and traffic["curved"]:
            apex = layers[0][1]
            R = config["curve_roc"]
            centre = np.array([apex + R, 0.0, 0.0])
            r = np.linalg.norm(cents - centre[None, :], axis=1)
            for name, xlo, xhi in layers:
                hit = (r > R - (xhi - apex)) & (r <= R - (xlo - apex)) & (cents[:, 0] < centre[0])
                c[hit], rho[hit], att[hit] = mats[name]
        else:
            for name, xlo, xhi in layers:
                hit = (cents[:, 0] >= xlo) & (cents[:, 0] < xhi)
                c[hit], rho[hit], att[hit] = mats[name]
    return {"c": c, "rho": rho, "delta": diffusivity(omega, c, att), "beta": beta}


class ReferenceModel:
    """The cell's discretised Westervelt problem on ``device``; float64, or
    float32 with TF32 stiffness products (``tf32=True``, the control)."""

    def __init__(self, config: dict, traffic: dict, device, tf32: bool = False):
        self.config, self.traffic = config, traffic
        mesh, h = build_mesh(config, traffic)
        self.geometry = {}
        if traffic["mesh"] == "bowl":
            self.geometry = bowl_readings(mesh, config["domain"]["L"], config["domain"]["W"],
                                          config["transducer"]["roc"],
                                          config["transducer"]["aperture_radius"])
        p = traffic.get("degree", config.get("degree"))
        self.disc = disc = Discretisation(mesh, p, device, tf32=tf32)
        med = build_media(config, traffic, mesh)
        c, rho, delta, beta = med["c"], med["rho"], med["delta"], med["beta"]
        self.f0 = config["f0"]
        self.w0 = 2 * math.pi * self.f0
        self.ramp_periods = config["source_ramp_periods"]
        if "source_velocity" in config:
            m = config["medium"]
            self.p0 = m["rho0"] * m["c0"] * config["source_velocity"]
            self.s0 = float(m["c0"])
        else:
            self.p0, self.s0 = float(config["p0"]), float(config["s0"])
        self.spp = steps_per_period(config, traffic, h, float(np.max(c)))
        self.dt = 1.0 / self.f0 / self.spp
        src, absorbing = mesh.facet_tags.get(1), mesh.facet_tags.get(2)
        self.m0 = disc.mass(1.0 / (rho * c * c)) + disc.facet(absorbing, delta / (rho * c**3))
        self.d2 = disc.mass(2.0 * beta / (rho * rho * c**4))
        self.abc = disc.facet(absorbing, 1.0 / (rho * c))
        self.coeffs = [disc.cellwise(1.0 / rho), disc.cellwise(delta / (rho * c * c))]
        self.phased = traffic["source"] == "phased"
        if self.phased:
            a, roc = config["transducer"]["aperture_radius"], config["transducer"]["roc"]
            _, _, xyz, cells = disc.facet_terms(src)
            c_src = float(np.mean(c[cells]))
            r2 = xyz[..., 1] ** 2 + xyz[..., 2] ** 2
            inside = np.sqrt(r2) <= a
            tau = (roc - np.sqrt(roc**2 - a**2 + r2)) / c_src * inside
            weight = inside * roc / np.sqrt(np.maximum(roc**2 - r2, roc**2 - a**2))
            self.src = {}
            for name, coeff in (("", 1.0 / rho), ("_d", delta / (rho * c * c))):
                self.src["cos" + name] = disc.facet(src, coeff, weight * np.cos(self.w0 * tau))
                self.src["sin" + name] = disc.facet(src, coeff, weight * np.sin(self.w0 * tau))
        else:
            self.src = {"g": disc.facet(src, 1.0 / rho),
                        "dg": disc.facet(src, delta / (rho * c * c))}

    def source(self, t: float) -> torch.Tensor:
        """g + dg at time t."""
        win, dwin = ramp(t, self.f0, self.ramp_periods)
        amp = self.p0 * self.w0 / self.s0
        cs, sn = math.cos(self.w0 * t), math.sin(self.w0 * t)
        s = self.src
        if self.phased:
            return ((win * amp) * (cs * s["cos"] + sn * s["sin"])
                    + (dwin * amp) * (cs * s["cos_d"] + sn * s["sin_d"])
                    + (win * amp * self.w0) * (-sn * s["cos_d"] + cs * s["sin_d"]))
        g = win * amp * cs
        dg = dwin * amp * cs - win * self.p0 * self.w0**2 / self.s0 * sn
        return g * s["g"] + dg * s["dg"]

    def rhs(self, t: float, u: torch.Tensor, v: torch.Tensor):
        b = (-self.disc.stiffness([u, v], self.coeffs) + self.source(t)
             - self.abc * v + self.d2 * (v * v))
        return v, b / (self.m0 - self.d2 * u)

    def march(self, u: torch.Tensor, v: torch.Tensor, t0: float, tf: float, sensors):
        """RK4 from (u, v) at t0 to tf, reading ``sensors`` = (DOFs, weights)
        after every step: (u, v, traces [steps, n] float64 host)."""
        rows, wts = sensors
        rows = torch.as_tensor(rows, device=u.device)
        wts = torch.as_tensor(wts, dtype=u.dtype, device=u.device)
        dts = step_sizes(t0, tf, self.dt)
        starts = float(t0) + np.concatenate([[0.0], np.cumsum(dts)[:-1]])
        traces = []
        for dt, t in zip(dts.tolist(), starts.tolist()):
            ku, kv = torch.zeros_like(u), torch.zeros_like(v)
            ua, va = u, v
            for a, b, c in zip(RK4_A, RK4_B, RK4_C):
                ku, kv = self.rhs(t + c * dt, u + (a * dt) * ku, v + (a * dt) * kv)
                ua = ua + (b * dt) * ku
                va = va + (b * dt) * kv
            u, v = ua, va
            traces.append((u[rows] * wts).sum(-1))
        return u, v, torch.stack(traces).double().cpu().numpy()
