"""exp3, conforming against non-conforming spatial source windows: the port
of ``experiments/exp3_source_conformity.py`` (reference
``python/experiments/exp3``): a window aligned with element boundaries and
one cutting through elements; the non-conforming source excites Gibbs
artifacts in the near field. fp64 on every device."""

import torch

from ..core.mesh import create_rectangle, tag_boundaries
from ..models.experimental import LinearSpectralS2, heaviside_window
from ..scripts import cli, device_dtype


def main(depth=1.0, device="cuda"):
    device, dtype = device_dtype(device, torch.float64)
    f0, c0, rho0 = 10.0, 1.0, 1.0
    L, W = 1.0, 1.0
    ny = 10
    hy = W / ny
    dt = 0.5 * (L / 10) / (c0 * 16)
    max_u, fields = {}, {}
    for b, label in [(2 * hy, "conforming (2 cells)"), (2.5 * hy, "non-conforming (2.5 cells)")]:
        mesh = create_rectangle((10, ny), (0, -W / 2), (L, W / 2))
        tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12}, default=2)
        eqn = LinearSpectralS2(mesh, None, 4, c0, rho0, f0, 1.0, c0,
                               source_profile=heaviside_window(-b, b, axis=1), dtype=dtype,
                               device=device)
        eqn.init()
        u, v, tf = eqn.rk4(0.0, depth * 0.5, dt)
        max_u[label], fields[label] = float(u.abs().max()), u
        print(f"{label}: max|u| = {max_u[label]:.4f}")
    return {"max_u": max_u, "u": fields, "t": tf}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
