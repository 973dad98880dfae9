"""exp2, p-convergence: the port of ``experiments/exp2_p_convergence.py``
(reference ``python/experiments/exp2``): L2 and H1 errors of the 1D planewave
against the polynomial degree at fixed elements per wavelength, and a line
evaluation of the last solution. fp64 on every device."""

import numpy as np
import torch

from ..analysis.analytical import planewave
from ..analysis.error import relative_h1_error, relative_l2_error
from ..core.mesh import create_interval, tag_boundaries
from ..models.linear import LinearSpectralExplicit
from ..scripts import cli, device_dtype
from ..utils import eval_function


def main(depth=1.0, device="cuda"):
    device, dtype = device_dtype(device, torch.float64)
    f0, c0, rho0, L = 10.0, 1.0, 4.0, 1.0
    p0 = rho0 * c0
    w0 = 2 * np.pi * f0
    epw = 4
    rows, fields = [], {}
    print(f"{'p':>2} {'L2 err':>12} {'H1 err':>12}")
    for degree in [2, 3, 4, 5, 6]:
        nx = int(epw * L * f0 / c0 + 1)
        mesh = create_interval(nx, 0, L)
        tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
        dt = 0.5 * (L / nx) / (c0 * degree**2)
        eqn = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                     dtype=dtype, device=device)
        eqn.init()
        u, v, tf = eqn.rk(0.0, depth * (L / c0 + 16.0 / f0))
        l2 = float(relative_l2_error(eqn.ops, u, lambda x: planewave(x[0], tf, c0, f0, p0)))

        def grad_exact(x):
            tau = tf - x[0] / c0
            return (-p0 * w0 / c0 * np.cos(w0 * tau) * np.heaviside(tau, 0))[None, :]

        h1 = float(relative_h1_error(eqn.ops, u, grad_exact))
        print(f"{degree:>2} {l2:12.3e} {h1:12.3e}")
        rows.append((degree, l2, h1))
        fields[degree] = u
    # line evaluation (sensor extraction)
    xs = np.linspace(0.05, 0.95, 7)
    pts, vals = eval_function(eqn.ops, u, xs[None, :])
    print("eval-on-line:", np.array2string(vals, precision=3))
    return {"rows": rows, "u": fields, "t": tf, "xs": xs, "eval_line": vals}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
