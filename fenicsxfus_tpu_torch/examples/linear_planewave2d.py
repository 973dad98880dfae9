"""2D linear planewave: the port of ``examples/linear_planewave2d.py``
(reference ``python/examples/linear_planewave2d_1_exp``): 0.5 MHz planewave in
a 0.12 m square, p=4 GLL, RK4 explicit, source on x=0 (tag 1), Sommerfeld ABC
elsewhere (tag 2). Writes ``{out}.npz`` and, where h5py imports, an XDMF
snapshot."""

from ..core.mesh import create_rectangle, tag_boundaries
from ..models.linear import LinearSpectralExplicit
from ..scripts import cli, device_dtype
from ._output import save


def main(epw=4, degree=4, out="linear_planewave2d", depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 0.5e6, 60000.0
    c0, rho0 = 1500.0, 1000.0
    L = 0.12
    lmbda = c0 / f0
    nx = int(epw * L / lmbda + 1)
    mesh = create_rectangle((nx, nx), (0, 0), (L, L))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    h = L / nx
    dt_cfl = 0.9 * h / (c0 * degree**2)
    steps_per_period = int(1 / f0 / dt_cfl + 1)
    dt = 1 / f0 / steps_per_period  # integer steps per period (reference :70-72)
    eqn = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                 dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk(0.0, depth * (L / c0 + 4.0 / f0))
    max_u = float(u.abs().max())
    print(f"DOFs {eqn.number_of_dofs()}, t={tf:.3e}, max|u| = {max_u:.1f} Pa")
    paths = save(out, eqn.ops, u, tf, xdmf=True)
    return {"u": u, "t": tf, "max_u": max_u, "paths": paths, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
