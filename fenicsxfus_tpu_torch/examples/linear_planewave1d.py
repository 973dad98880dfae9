"""1D linear planewave, explicit RK: the port of ``examples/linear_planewave1d.py``
(reference ``python/examples/linear_planewave1d_1_exp`` and, with
``hetero=True``, the two-medium ``linear_planewave1d_2_exp``): 0.5 MHz source
on x=0 (tag 1), Sommerfeld ABC at x=L (tag 2)."""

import numpy as np

from ..core.mesh import create_interval, tag_boundaries
from ..models.linear import LinearSpectralExplicit
from ..scripts import cli, device_dtype
from ..utils import eval_function


def main(epw=8, degree=4, rk=2, hetero=False, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0 = 0.5e6
    c_w, rho_w = 1500.0, 1000.0
    p0 = rho_w * c_w * 0.04  # velocity amplitude 0.04 m/s (reference :35-37)
    L = 0.12
    nx = int(epw * L * f0 / c_w + 1)
    mesh = create_interval(nx, 0.0, L)
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    if hetero:  # water | bone split at L/2 (reference *_2_exp variant)
        mids = mesh.cell_vertices().mean(axis=1)
        bone = mids[:, 0] >= L / 2
        c0 = np.where(bone, 2800.0, c_w)
        rho0 = np.where(bone, 1850.0, rho_w)
        c_max = 2800.0
    else:
        c0, rho0, c_max = c_w, rho_w, c_w
    h = L / nx
    dt = 0.1 * h / (c_max * degree**2)  # reference CFL=0.1 for the RK2 pair
    eqn = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c_w, rk, dt,
                                 dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk(0.0, depth * (L / c_w + 4.0 / f0))
    xs = np.linspace(0.0, L, 200)
    _, uu = eval_function(eqn.ops, u, xs[None, :])
    max_u = float(np.abs(uu).max())
    print(f"DOFs {eqn.number_of_dofs()}, t={tf:.3e}, max|u| = {max_u:.1f} Pa"
          + (" (heterogeneous water|bone)" if hetero else ""))
    return {"xs": xs, "u_line": uu, "u": u, "t": tf, "max_u": max_u, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
