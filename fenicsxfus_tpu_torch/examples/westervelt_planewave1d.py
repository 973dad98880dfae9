"""1D Westervelt planewave: the port of ``examples/westervelt_planewave1d.py``
(reference ``python/examples/westervelt_planewave1d_1_exp``): 1 MHz, 125 kPa
drive in water; the domain spans ~0.86 shock-formation distances, so the
waveform steepens visibly."""

import numpy as np

from ..core.mesh import create_interval, tag_boundaries
from ..models.westervelt import WesterveltSpectralExplicit
from ..scripts import cli, device_dtype
from ..utils import compute_diffusivity_of_sound, eval_function


def main(epw=3, degree=4, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 1e6, 125000.0
    c0, rho0 = 1482.32, 998.2
    beta0, alphadB = 3.5, 2.0
    w0 = 2 * np.pi * f0
    delta0 = compute_diffusivity_of_sound(w0, c0, alphadB)
    L = 0.12
    xsh = rho0 * c0**3 / beta0 / p0 / w0  # shock formation distance
    # steepened harmonics need extra resolution: resolve ~10 harmonics of
    # content at epw elements per (fundamental) wavelength / 4 harmonics
    nx = int(10 * epw * L * f0 / c0 / 4 + 1)
    mesh = create_interval(nx, 0.0, L)
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    h = L / nx
    dt = 0.45 * h / (c0 * degree**2)
    eqn = WesterveltSpectralExplicit(mesh, None, degree, c0, rho0, delta0, beta0, f0, p0, c0,
                                     4, dt, dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk(0.0, depth * (L / c0 + 4.0 / f0))
    xs = np.linspace(0.0, L, 400)
    _, uu = eval_function(eqn.ops, u, xs[None, :])
    max_u = float(np.abs(uu).max())
    print(f"DOFs {eqn.number_of_dofs()}, L/x_sh = {L / xsh:.2f}, "
          f"max|u| = {max_u:.0f} Pa (p0 = {p0:.0f}; steepening raises the peak above p0)")
    return {"xs": xs, "u_line": uu, "u": u, "t": tf, "max_u": max_u, "L_over_xsh": L / xsh,
            "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
