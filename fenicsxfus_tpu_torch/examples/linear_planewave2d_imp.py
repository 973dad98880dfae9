"""2D linear planewave, implicit SDIRK: the port of
``examples/linear_planewave2d_imp.py`` (reference
``python/examples/linear_planewave2d_1_imp``, ``_linear.py:516-817``), the
implicit counterpart of ``linear_planewave2d``. Writes ``{out}.npz``."""

from ..core.mesh import create_rectangle, tag_boundaries
from ..models.linear import LinearSpectralImplicit
from ..scripts import cli, device_dtype
from ._output import save


def main(epw=4, degree=4, rk_order=2, out="linear_planewave2d_imp", depth=1.0, dtype=None,
         device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 0.5e6, 60000.0
    c0, rho0 = 1500.0, 1000.0
    L = 0.12
    lmbda = c0 / f0
    nx = int(epw * L / lmbda + 1)
    mesh = create_rectangle((nx, nx), (0, 0), (L, L))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    h = L / nx
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
    paths = save(out, eqn.ops, u, tf, xdmf=False)
    return {"u": u, "t": tf, "max_u": max_u, "cg_max_iterations": st["max_iterations"],
            "cg_max_residual2": st["max_residual2"], "paths": paths, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
