"""1D linear planewave with Newmark-β time stepping: the port of
``examples/linear_planewave1d_newmark.py`` (reference
``python/examples/linear_planewave1d_1_newmark``, ``_experimental.py:13-251``):
γ=1/2, β=1/4 with a matrix-free CG solve per step, against the analytical
travelling wave (relative L2 < 5e-2 at the whole horizon). fp64 on every
device, as the JAX script."""

from ..analysis.analytical import planewave
from ..analysis.error import relative_l2_error
from ..core.mesh import create_interval, tag_boundaries
from ..models.experimental import LinearSpectralNewmark
from ..scripts import cli, device_dtype


def main(epw=4, degree=4, depth=1.0, device="cuda"):
    import torch

    device, dtype = device_dtype(device, torch.float64)
    f0, p0 = 10.0, 1.0
    c0, rho0 = 1.0, 1.0
    L = 1.0
    lmbda = c0 / f0
    nx = int(epw * L / lmbda + 1)
    mesh = create_interval(nx, 0.0, L)
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    h = L / nx
    dt = 0.5 * h / (c0 * degree**2)
    eqn = LinearSpectralNewmark(mesh, None, degree, c0, rho0, f0, p0, c0, dt, dtype=dtype,
                                device=device)
    eqn.init()
    u, v, w, tf = eqn.newmark(0.0, depth * (L / c0 + 4.0 / f0))
    err = float(relative_l2_error(eqn.ops, u, lambda x: planewave(x[0], tf, c0, f0, p0)))
    print(f"DOFs {eqn.number_of_dofs()}, t={tf:.4f}, rel L2 vs analytical = {err:.3e}")
    if depth == 1.0 and not err < 5e-2:
        raise AssertionError(f"rel L2 vs analytical {err:.3e} >= 5e-2")
    return {"u": u, "v": v, "w": w, "t": tf, "err": err, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
