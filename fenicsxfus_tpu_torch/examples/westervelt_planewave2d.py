"""2D Westervelt planewave: the port of ``examples/westervelt_planewave2d.py``
(reference ``python/examples/westervelt_planewave2d_1_exp``): finite-amplitude
nonlinear steepening with attenuation."""

import numpy as np

from ..core.mesh import create_rectangle, tag_boundaries
from ..models.westervelt import WesterveltSpectralExplicit
from ..scripts import cli, device_dtype
from ..utils import compute_diffusivity_of_sound


def main(epw=8, degree=4, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 1e6, 1e6  # strong drive -> visible nonlinearity
    c0, rho0, beta0 = 1500.0, 1000.0, 3.5
    delta0 = compute_diffusivity_of_sound(2 * np.pi * f0, c0, 2.0)
    L = 0.06
    nx = int(epw * L * f0 / c0 + 1)
    mesh = create_rectangle((nx, max(nx // 8, 2)), (0, 0), (L, L / 8))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > L - 1e-9})
    h = L / nx
    dt = 0.25 * h / (c0 * degree**2)
    eqn = WesterveltSpectralExplicit(mesh, None, degree, c0, rho0, delta0, beta0, f0, p0, c0,
                                     4, dt, dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk(0.0, depth * (L / c0 + 4.0 / f0))
    max_u = float(u.abs().max())
    print(f"max|u| = {max_u:.3e} Pa")
    return {"u": u, "t": tf, "max_u": max_u, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
