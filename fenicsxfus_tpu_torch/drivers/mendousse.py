"""MENDOUSSE benchmark, 1D Westervelt against the Mendousse analytical
solution: the port of ``benchmarks/mendousse.py`` (reference
``python/benchmarks/MENDOUSSE/mendousse.py``): a nonlinear and thermoviscous
plane wave at 1 MHz / 5 MPa, p = 10, 6 elements per wavelength, read at
sensors σ = x/x_sh ∈ {0.1, 0.5, 1} and held against Mendousse's exact
Fourier solution of the Burgers equation (PASS: every relative error < 0.2).
``quick=True`` runs L = 0.03 m at p = 6. fp32 on the card, fp64 on the CPU,
as the JAX script.

    python -m fenicsxfus_tpu_torch.drivers.mendousse [--quick] [--device cpu]
"""

import time

import numpy as np

from ..analysis.analytical import mendousse
from ..core.mesh import create_interval, tag_boundaries
from ..models.westervelt import WesterveltSpectralExplicit
from ..scripts import cli, device_dtype
from ..utils import compute_diffusivity_of_sound, eval_function


def main(quick=False, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    # Source / material parameters (reference :23-36)
    f0 = 1e6
    w0 = 2 * np.pi * f0
    p0 = 5e6
    c0, rho0 = 1500.0, 1000.0
    beta0 = 4.8
    alphadB = 25.0
    delta0 = compute_diffusivity_of_sound(w0, c0, alphadB)

    xsh = rho0 * c0**3 / beta0 / p0 / w0  # shock formation distance
    sigma = np.array([0.1, 0.5, 1.0])
    sensors = sigma * xsh
    L = 0.09 if not quick else 0.03
    degree = 10 if not quick else 6
    epw = 6
    lmbda = c0 / f0
    nx = int(epw * L / lmbda + 1)
    h = L / nx

    mesh = create_interval(nx, 0.0, L)
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    dt = 0.25 * h / (c0 * degree**2)
    eqn = WesterveltSpectralExplicit(mesh, None, degree, c0, rho0, delta0, beta0, f0, p0, c0,
                                     4, dt, dtype=dtype, device=device)
    eqn.init()
    tend = depth * (L / c0 + 8.0 / f0)
    t0 = time.perf_counter()
    u, v, tf = eqn.rk(0.0, tend)
    elapsed = time.perf_counter() - t0
    print(f"DOFs: {eqn.number_of_dofs()}, steps dt={dt:.3e}, solve {elapsed:.1f}s")

    pts = np.stack([sensors], axis=0)
    p_eval, vals = eval_function(eqn.ops, u, pts)
    print(f"{'sigma':>6} {'x (m)':>10} {'numerical':>12} {'mendousse':>12} {'rel err':>9}")
    ok = True
    rows = []
    for s, x, val in zip(sigma, p_eval[:, 0], vals):
        exact = float(mendousse(x, tf, c0, f0, p0, rho0, beta0, delta0))
        rel = abs(val - exact) / (abs(exact) + 1e-3 * p0)
        ok &= rel < 0.2
        rows.append((float(s), float(x), float(val), exact, float(rel)))
        print(f"{s:6.2f} {x:10.4f} {val:12.1f} {exact:12.1f} {rel:9.3f}")
    print("PASS" if ok else "CHECK: sensor mismatch")
    return {"u": u, "t": tf, "rows": rows, "ok": bool(ok), "solve_s": elapsed, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
