"""2D planewave with a sponge-layer absorber pad: the port of
``examples/linear_planewave2d_sponge.py`` (reference
``python/examples/linear_planewave2d_2``)."""

from ..core.mesh import create_rectangle, tag_boundaries
from ..models.experimental import LinearSpectralSponge
from ..scripts import cli, device_dtype


def main(epw=4, degree=4, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 0.5e6, 60000.0
    c0, rho0 = 1500.0, 1000.0
    L, pad = 0.12, 0.03  # domain + sponge pad
    nx = int(epw * (L + pad) * f0 / c0 + 1)
    ny = int(epw * L * f0 / c0 + 1)
    mesh = create_rectangle((nx, ny), (0, 0), (L + pad, L))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    h = (L + pad) / nx
    dt = 0.25 * h / (c0 * degree**2)
    delta0 = 2 * c0 / (2 * 3.14159265 * f0) * 8.0
    eqn = LinearSpectralSponge(mesh, None, degree, c0, rho0, delta0, f0, p0, c0,
                               sponge_start=L, dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk4(0.0, depth * ((L + pad) / c0 + 2.0 / f0), dt)
    max_u = float(u.abs().max())
    print(f"max|u| = {max_u:.3e}")
    return {"u": u, "t": tf, "max_u": max_u, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
