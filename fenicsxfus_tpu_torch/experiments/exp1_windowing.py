"""exp1, the effect of the source ramp window: the port of
``experiments/exp1_windowing.py`` (reference ``python/experiments/exp1``):
the 1D linear problem with and without the 4-period cosine ramp, each against
the steady plane wave (the window suppresses the broadband onset). fp64 on
every device."""

import torch

from ..analysis.analytical import planewave
from ..analysis.error import relative_l2_error
from ..core.mesh import create_interval, tag_boundaries
from ..models.linear import LinearSpectralExplicit
from ..scripts import cli, device_dtype


def main(depth=1.0, device="cuda"):
    device, dtype = device_dtype(device, torch.float64)
    f0, c0, rho0, L = 10.0, 1.0, 1.0, 1.0
    degree, epw = 4, 4
    nx = int(epw * L * f0 / c0 + 1)
    mesh = create_interval(nx, 0, L)
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    dt = 0.9 * (L / nx) / (c0 * degree**2)
    errors, fields = {}, {}
    for alpha, label in [(4.0, "4-period ramp"), (0.02, "~no window")]:
        eqn = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, 1.0, c0, 4, dt,
                                     dtype=dtype, device=device)
        eqn.alpha = alpha
        eqn.consts["alpha"] = alpha
        eqn.init()
        u, v, tf = eqn.rk(0.0, depth * (L / c0 + 16.0 / f0))
        err = float(relative_l2_error(eqn.ops, u, lambda x: planewave(x[0], tf, c0, f0, 1.0)))
        print(f"{label:>16}: rel L2 vs steady planewave = {err:.3e}")
        errors[label], fields[label] = err, u
    return {"errors": errors, "u": fields, "t": tf}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
