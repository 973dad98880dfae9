"""exp5, stiffness of the lossy system against the δ magnitude: the port of
``experiments/exp5_delta_stiffness.py`` (reference ``python/experiments/exp5``):
the diffusive term δ∇²(u_t) adds an O(δ/h²) eigenvalue, which shrinks the
stable explicit dt as δ grows. For each δ, the largest dt/dt0 in
1, 1/2, ..., 1/16 whose run stays finite and below 100. fp64 on every
device."""

import torch

from ..core.mesh import create_interval, tag_boundaries
from ..models.lossy import LossySpectralExplicit
from ..scripts import cli, device_dtype


def main(depth=1.0, device="cuda"):
    device, dtype = device_dtype(device, torch.float64)
    f0, c0, rho0, L = 10.0, 1.0, 1.0, 1.0
    degree, epw = 4, 4
    nx = int(epw * L * f0 / c0 + 1)
    mesh = create_interval(nx, 0, L)
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    h = L / nx
    dt0 = 0.9 * h / (c0 * degree**2)
    stable, runs = {}, []
    print(f"{'delta':>10} {'dt/dt0 stable':>14}")
    for delta in [0.0, 2e-3, 2e-2, 8e-2]:
        stable_frac = None
        for frac in [1.0, 0.5, 0.25, 0.125, 0.0625]:
            eqn = LossySpectralExplicit(mesh, None, degree, c0, rho0, delta, f0, 1.0, c0, 4,
                                        frac * dt0, dtype=dtype, device=device)
            eqn.init()
            u, v, tf = eqn.rk(0.0, depth * 0.8)
            runs.append((delta, frac, u))
            if bool(torch.isfinite(u).all()) and float(u.abs().max()) < 100:
                stable_frac = frac
                break
        stable[delta] = stable_frac
        print(f"{delta:10.1e} {stable_frac if stable_frac else '<0.0625':>14}")
    return {"stable": stable, "runs": runs}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
