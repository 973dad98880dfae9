"""2D linear planewave with a spatially windowed source s(x)·g(t): the port
of ``examples/linear_planewave2d_windowed.py`` (reference
``python/examples/linear_planewave2d_5``): the source is active only on a
window of the x=0 boundary (a Heaviside or Tukey profile), driven through
``LinearSpectralS2`` (reference ``_experimental.py:254-540``)."""

import numpy as np

from ..core.mesh import create_rectangle, tag_boundaries
from ..models.experimental import LinearSpectralS2, heaviside_window, tukey_window
from ..scripts import cli, device_dtype


def main(epw=4, degree=4, window="heaviside", depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 0.5e6, 60000.0
    c0, rho0 = 1500.0, 1000.0
    L = 0.12
    a = 0.011  # half-width of the active source strip
    lmbda = c0 / f0
    nx = int(epw * L / lmbda + 1)
    mesh = create_rectangle((nx, nx), (0, -L / 2), (L, L / 2))
    eps = 1e-9
    tag_boundaries(mesh, {1: lambda x: x[0] < eps}, default=2)
    h = L / nx
    dt = 0.9 * h / (c0 * degree**2)
    profile = {
        "heaviside": heaviside_window(-a, a, axis=1),
        "tukey": tukey_window(a / 2, a, axis=1),
    }[window]
    eqn = LinearSpectralS2(mesh, None, degree, c0, rho0, f0, p0, c0, source_profile=profile,
                           dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk4(0.0, depth * (L / c0 + 4.0 / f0), dt)
    un = u.abs().cpu().numpy()
    coords = eqn.ops.space.dof_coords
    on_axis = float(un[np.abs(coords[:, 1]) < a / 2].max())
    off_axis = float(un[np.abs(coords[:, 1]) > L / 3].max())
    print(f"DOFs {eqn.number_of_dofs()}: max|u| on-axis {on_axis:.1f} Pa, "
          f"far off-axis {off_axis:.1f} Pa (windowed beam)")
    return {"u": u, "t": tf, "on_axis": on_axis, "off_axis": off_axis, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
