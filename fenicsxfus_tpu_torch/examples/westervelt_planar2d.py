"""2D Westervelt planar-transducer problem, explicit RK: the port of
``examples/westervelt_planar2d.py`` (reference
``python/examples/westervelt_planar2d_1_exp``): nonlinear propagation from a
finite-width strip source, harmonic generation along the beam axis, read at
24 axial sensors. Writes ``{out}.npz``."""

import numpy as np

from ..core.mesh import create_rectangle, tag_boundaries
from ..models.westervelt import WesterveltSpectralExplicit
from ..scripts import cli, device_dtype
from ..utils import compute_diffusivity_of_sound, eval_function
from ._output import save


def main(epw=6, degree=4, out="westervelt_planar2d", depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 1.0e6, 1.0e6  # 1 MPa drive: visible nonlinearity in 0.12 m
    c0, rho0, beta0 = 1500.0, 1000.0, 3.5
    alpha_dB = 2.0
    w0 = 2.0 * np.pi * f0
    delta0 = compute_diffusivity_of_sound(w0, c0, alpha_dB)
    L = 0.12
    a = 0.01
    lmbda = c0 / f0
    nx = int(epw * L / lmbda + 1)
    mesh = create_rectangle((nx, nx), (0, -L / 2), (L, L / 2))
    eps = 1e-9
    tag_boundaries(mesh, {
        1: lambda x: (x[0] < eps) & (np.abs(x[1]) <= a),
        2: lambda x: (x[0] > L - eps) | (np.abs(x[1]) > L / 2 - eps),
    })
    h = L / nx
    dt_cfl = 0.5 * h / (c0 * degree**2)
    spp = int(1 / f0 / dt_cfl + 1)
    dt = 1 / f0 / spp
    eqn = WesterveltSpectralExplicit(mesh, None, degree, c0, rho0, delta0, beta0, f0, p0, c0,
                                     4, dt, dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk(0.0, depth * (L / c0 + 4.0 / f0))
    # axial sensor profile
    xs = np.linspace(0.005, L - 0.005, 24)
    pts = np.stack([xs, np.zeros_like(xs)])
    _, vals = eval_function(eqn.ops, u, pts)
    max_axial = float(np.max(np.abs(vals)))
    print(f"DOFs {eqn.number_of_dofs()}, t={tf:.3e}, max axial |p| = {max_axial / 1e6:.3f} MPa "
          f"(drive {p0 / 1e6:.1f} MPa)")
    paths = save(out, eqn.ops, u, tf, xdmf=False)
    return {"u": u, "t": tf, "xs": xs, "axial": vals, "max_axial": max_axial, "paths": paths,
            "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
