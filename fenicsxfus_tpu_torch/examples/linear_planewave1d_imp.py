"""1D linear planewave, SDIRK implicit: the port of
``examples/linear_planewave1d_imp.py`` (reference
``python/examples/linear_planewave1d_1_imp``): the problem of
``linear_planewave1d`` integrated with the implicit solver at a dt above the
explicit CFL limit."""

import numpy as np

from ..core.mesh import create_interval, tag_boundaries
from ..models.linear import LinearSpectralImplicit
from ..scripts import cli, device_dtype
from ..utils import eval_function


def main(epw=8, degree=4, rk=2, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0 = 0.5e6
    c0, rho0 = 1500.0, 1000.0
    p0 = rho0 * c0 * 0.04
    L = 0.12
    nx = int(epw * L * f0 / c0 + 1)
    mesh = create_interval(nx, 0.0, L)
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    dt = 1.0 / f0 / 20  # 20 steps/period, ~4x the explicit CFL dt
    eqn = LinearSpectralImplicit(mesh, None, degree, c0, rho0, f0, p0, c0, rk, dt,
                                 dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.dirk(0.0, depth * (L / c0 + 4.0 / f0))
    xs = np.linspace(0.0, L, 200)
    _, uu = eval_function(eqn.ops, u, xs[None, :])
    max_u = float(np.abs(uu).max())
    st = eqn.cg_stats
    print(f"DOFs {eqn.number_of_dofs()}, t={tf:.3e}, max|u| = {max_u:.1f} Pa, "
          f"CG worst iters={st['max_iterations']}")
    return {"xs": xs, "u_line": uu, "u": u, "t": tf, "max_u": max_u,
            "cg_max_iterations": st["max_iterations"], "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
