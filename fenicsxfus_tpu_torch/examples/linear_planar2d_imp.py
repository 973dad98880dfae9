"""2D linear planar-transducer problem, implicit SDIRK: the port of
``examples/linear_planar2d_imp.py`` (reference
``python/examples/linear_planar2d_1_imp``): the explicit driver's geometry,
marched with 2-stage SDIRK and matrix-free CG+Jacobi (reference KSP CG,
``_linear.py:644-647``), with the CG stats. Writes ``{out}.npz`` and, where
h5py imports, an XDMF snapshot."""

import numpy as np

from ..core.mesh import create_rectangle, tag_boundaries
from ..models.linear import LinearSpectralImplicit
from ..scripts import cli, device_dtype
from ._output import save


def main(epw=4, degree=4, rk_order=2, out="linear_planar2d_imp", depth=1.0, dtype=None,
         device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 0.5e6, 60000.0
    c0, rho0 = 1500.0, 1000.0
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
    # implicit: no CFL stability limit; step at 4x the explicit dt
    # (accuracy-limited, the reference's implicit examples take larger steps too)
    dt_cfl = 4.0 * 0.9 * h / (c0 * degree**2)
    spp = int(1 / f0 / dt_cfl + 1)
    dt = 1 / f0 / spp
    eqn = LinearSpectralImplicit(mesh, None, degree, c0, rho0, f0, p0, c0, rk_order, dt,
                                 dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.dirk(0.0, depth * (L / c0 + 4.0 / f0))
    max_u = float(u.abs().max())
    st = eqn.cg_stats
    print(f"DOFs {eqn.number_of_dofs()}, t={tf:.3e}, max|u| = {max_u:.1f} Pa, "
          f"CG worst {st['max_iterations']} iters (final ||r||^2 {st['max_residual2']:.2e})")
    paths = save(out, eqn.ops, u, tf, xdmf=True)
    return {"u": u, "t": tf, "max_u": max_u, "cg_max_iterations": st["max_iterations"],
            "cg_max_residual2": st["max_residual2"], "paths": paths, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
