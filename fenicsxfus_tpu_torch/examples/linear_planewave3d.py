"""3D linear planewave on a hex box, the flagship problem family: the port of
``examples/linear_planewave3d.py`` (cf. reference
``cpp/fenicsx-sf-naive/examples/linear_planewave3d_*``). fp32 unless
``dtype`` says otherwise, as the JAX script; on the card each RK4 stage is
one K2 launch."""

import torch

from ..core.mesh import create_box, tag_boundaries
from ..models.linear import LinearSpectralExplicit
from ..scripts import cli, device_dtype


def main(nx=32, degree=4, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype, cpu_dtype=torch.float32)
    f0, p0 = 0.5e6, 60000.0
    c0, rho0 = 1500.0, 1000.0
    L = 0.12
    mesh = create_box((nx, nx, nx), (0, 0, 0), (L, L, L))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    h = L / nx
    dt = 0.9 * h / (c0 * degree**2)
    eqn = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                 dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk(0.0, depth * (L / c0 + 2.0 / f0))
    max_u = float(u.abs().max())
    print(f"{eqn.number_of_dofs() / 1e6:.1f}M DOFs, max|u| = {max_u:.1f} Pa")
    return {"u": u, "t": tf, "max_u": max_u, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
