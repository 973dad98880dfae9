"""2D lossy planewave: the port of ``examples/lossy_planewave2d.py`` (reference
``python/examples/lossy_planewave2d_1_exp``): the 2D planewave problem with
diffusivity-of-sound attenuation."""

import numpy as np

from ..core.mesh import create_rectangle, tag_boundaries
from ..models.lossy import LossySpectralExplicit
from ..scripts import cli, device_dtype
from ..utils import compute_diffusivity_of_sound


def main(epw=4, degree=4, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 0.5e6, 60000.0
    c0, rho0 = 1500.0, 1000.0
    alpha_dB = 50.0
    delta0 = compute_diffusivity_of_sound(2 * np.pi * f0, c0, alpha_dB)
    L = 0.12
    nx = int(epw * L * f0 / c0 + 1)
    mesh = create_rectangle((nx, nx), (0, 0), (L, L))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    h = L / nx
    dt = 0.5 * h / (c0 * degree**2)
    eqn = LossySpectralExplicit(mesh, None, degree, c0, rho0, delta0, f0, p0, c0, 4, dt,
                                dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk(0.0, depth * (L / c0 + 4.0 / f0))
    max_u = float(u.abs().max())
    print(f"max|u| = {max_u:.1f} Pa (attenuated from {p0:.0f})")
    return {"u": u, "t": tf, "max_u": max_u, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
