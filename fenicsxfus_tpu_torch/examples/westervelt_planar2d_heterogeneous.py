"""2D Westervelt planar transducer through a bone layer (water|bone|water):
the port of ``examples/westervelt_planar2d_heterogeneous.py`` (reference
``python/examples/westervelt_planar2d_4_exp``): nonlinear propagation with a
cortical-bone slab at 0.03 m < x < 0.0365 m, DG-0 material fields (c, rho,
beta, delta) per region, explicit RK4."""

import numpy as np

from ..core.mesh import create_rectangle, tag_boundaries
from ..models.westervelt import WesterveltSpectralExplicit
from ..scripts import cli, device_dtype
from ..utils import compute_diffusivity_of_sound


def main(epw=4, degree=4, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 0.5e6, 60000.0
    w0 = 2 * np.pi * f0
    c_w, rho_w, beta_w, alpha_w = 1500.0, 1000.0, 100.0, 0.0
    c_b, rho_b, beta_b, alpha_b = 2800.0, 1850.0, 200.0, 400.0
    L = 0.12
    x_b0, x_b1 = 0.03, 0.0365  # bone slab (reference :36-41 region layout)
    a = 0.01
    lmbda = c_w / f0
    nx = int(epw * L / lmbda + 1)
    mesh = create_rectangle((nx, nx), (0, -L / 2), (L, L / 2))
    eps = 1e-9
    tag_boundaries(mesh, {
        1: lambda x: (x[0] < eps) & (np.abs(x[1]) <= a),
        2: lambda x: (x[0] > L - eps) | (np.abs(x[1]) > L / 2 - eps),
    })
    mids = mesh.cell_vertices().mean(axis=1)
    bone = (mids[:, 0] >= x_b0) & (mids[:, 0] <= x_b1)
    c0 = np.where(bone, c_b, c_w)
    rho0 = np.where(bone, rho_b, rho_w)
    beta0 = np.where(bone, beta_b, beta_w)
    delta0 = np.where(bone, compute_diffusivity_of_sound(w0, c_b, alpha_b),
                      compute_diffusivity_of_sound(w0, c_w, alpha_w))
    h = L / nx
    dt = 0.35 * h / (c_b * degree**2)
    eqn = WesterveltSpectralExplicit(mesh, None, degree, c0, rho0, delta0, beta0, f0, p0, c_w,
                                     4, dt, dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk(0.0, depth * (L / c_w + 2.0 / f0))
    un = u.abs().cpu().numpy()
    x = eqn.ops.space.dof_coords[:, 0]
    pre = float(un[x < x_b0 - 0.005].max())
    post = float(un[x > x_b1 + 0.005].max())
    print(f"DOFs {eqn.number_of_dofs()}: max|u| before bone {pre:.1f} Pa, "
          f"after {post:.1f} Pa (transmission loss through the slab)")
    return {"u": u, "t": tf, "before": pre, "after": post, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
