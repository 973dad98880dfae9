"""PH1 SC1-BM1 as a single script: the port of ``benchmarks/ph1_sc1_bm1.py``
(reference ``cpp/fenicsx-sf-naive/benchmarks/PH1/SC1-BM1/main.cpp``: the
Aubry et al. benchmark at 0.5 MHz, 60 kPa, water only, p = 4, linear wave, a
circular piston of 2 cm diameter on the x = 0 face).

The piston is a nodal source window (``LinearSpectralS2`` with the disc
r ≤ 0.01 m on x = 0 as its ``source_profile``) on the 0.12 m cube
``create_box((nx,)*3)``: tag 1 the whole x = 0 face, the first-order ABC on
the five others. At the default nx = 60 (241³ = 13,997,521 DOF) it runs
``periods`` crossings of the cube with dt = cfl·h/(c0 p²), in fp32 on the
card (fp64 on the CPU, as the JAX script takes its dtype from the backend),
on the unfused step (S2 declares no fused kind: K1 4 times a step), and
reads the axial pressure at 24 points from x = 5 mm to 115 mm on the axis
through ``eval_function``.

The JAX script's dt is cfl = 0.9 (about 2134 steps at nx = 60), and at that
dt the cube's run diverges in both packages: the ABC terms where two or
three ABC faces meet (the cube's edges and corners, whose lumped mass is
smallest) leave RK4's stable interval, while the stiffness alone allows
1.66 (``estimate_stable_dt`` over h/(c0 p²) at nx = 16). After two
crossings in fp64 max|u| is 1.7e5 Pa at nx = 12 and 5.3e8 at nx = 16 (6.0e4
is the source), and at nx = 60 in fp32 the axial values are NaN. So the
default here is cfl = 0.5 (the suite's SC1-BM1 CFL; 3840 steps at nx = 60;
at nx = 16 cfl 0.6, 0.5 and 0.4 end within 1% of each other); ``--cfl 0.9``
is the JAX script's run.

It is not the suite's SC1-BM1 (``drivers/ph1.py``): that one runs the
benchmark's 0.12 × 0.07 × 0.07 m domain with the disc as its own facet tag
(the rest of the x = 0 plane a rigid baffle), the fused model
``LinearSpectralExplicit`` (K2 a stage) at a CFL of 0.5, for the
published sensors and the piston oracle's gates; this script keeps the JAX
script's cube, its windowed source and its 24 axial points.

    python -m fenicsxfus_tpu_torch.drivers.ph1_sc1_bm1 [--nx 60] [--periods 2] [--cfl 0.5]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.mesh import create_box, tag_boundaries
from ..models.common import step_sizes
from ..models.experimental import LinearSpectralS2
from ..scripts import cli, device_dtype
from ..utils import eval_function

F0, P0, C0, RHO0 = 0.5e6, 60000.0, 1500.0, 1000.0
L = 0.12
DEGREE = 4
A_SRC = 0.01  # piston radius (2 cm diameter)


def build(nx: int = 60, cfl: float = 0.5, dtype=None, device="cuda"):
    """The script's model, initialised, and its dt."""
    dev, dtype = device_dtype(device, dtype)
    mesh = create_box((nx, nx, nx), (0, 0, 0), (L, L, L))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)

    def piston(x):
        r2 = (x[1] - L / 2) ** 2 + (x[2] - L / 2) ** 2
        return np.where(x[0] < 1e-9, np.where(r2 <= A_SRC**2, 1.0, 0.0), 0.0)

    eqn = LinearSpectralS2(mesh, None, DEGREE, C0, RHO0, F0, P0, C0, source_profile=piston,
                           dtype=dtype, device=dev)
    eqn.init()
    return eqn, cfl * (L / nx) / (C0 * DEGREE**2)


def main(nx: int = 60, periods: float = 2.0, cfl: float = 0.5, dtype=None, device="cuda"
         ) -> dict:
    """The run: its size, solve seconds and rate (on the card), and the
    axial pressure (``x``, ``values``) at the final time ``t``."""
    t0 = time.perf_counter()
    eqn, dt = build(nx, cfl, dtype, device)
    dev = eqn.u_n.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup = time.perf_counter() - t0
    tend = periods * L / C0
    t0 = time.perf_counter()
    u, v, tf = eqn.rk4(0.0, tend, dt)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    n = eqn.number_of_dofs()
    nsteps = len(step_sizes(0.0, tend, dt))
    print(f"PH1 SC1-BM1: {n / 1e6:.1f}M DOF p={DEGREE}, {nsteps} steps ({eqn.step_kind} step, "
          f"{eqn.ops.dtype}, {dev}): setup {setup:.1f} s, solve {elapsed:.1f} s "
          f"({n * nsteps / elapsed / 1e9:.3f} GDOF-steps/s)")
    xs = np.linspace(0.005, L - 0.005, 24)
    pts = np.stack([xs, np.full_like(xs, L / 2), np.full_like(xs, L / 2)])
    _, vals = eval_function(eqn.ops, u, pts)
    print("axial pressure (Pa) at t=%.2e:" % tf)
    for x, val in zip(xs, vals):
        print(f"  x={x:7.4f}  p={val:12.1f}")
    if not np.all(np.isfinite(vals)) or len(vals) != len(xs):
        raise RuntimeError("PH1 SC1-BM1: the axial pressure is not 24 finite values")
    return {"ndofs": n, "nsteps": nsteps, "dt": dt, "setup_s": setup, "solve_s": elapsed,
            "rate": n * nsteps / elapsed / 1e9, "x": xs, "values": vals, "t": tf, "eqn": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
