"""exp4, temporal convergence of the RK integrators: the port of
``experiments/exp4_rk_order.py`` (reference ``python/experiments/exp4``):
halve dt twice for RK1-RK4 and check that the observed order matches the
tableau's, against a tiny-dt RK4 reference. fp64 on every device."""

import numpy as np
import torch

from ..core.mesh import create_interval, tag_boundaries
from ..models.linear import LinearSpectralExplicit
from ..scripts import cli, device_dtype


def main(depth=1.0, device="cuda"):
    device, dtype = device_dtype(device, torch.float64)
    f0, c0, rho0, L = 10.0, 1.0, 1.0, 1.0
    degree, nx = 6, 21  # spatial error far below temporal
    mesh = create_interval(nx, 0, L)
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    tend = depth * 0.2
    # reference solution: tiny-dt RK4, computed once
    ref = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, 1.0, c0, 4, 2.5e-5,
                                 dtype=dtype, device=device)
    ref.init()
    u_ref, _, _ = ref.rk(0.0, tend)
    errors, rates = {}, {}
    for order in [1, 2, 3, 4]:
        errs = []
        dts = [4e-4 / 2**k for k in range(3)]
        for dt in dts:
            eqn = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, 1.0, c0, order, dt,
                                         dtype=dtype, device=device)
            eqn.init()
            u, _, _ = eqn.rk(0.0, tend)
            errs.append(float(torch.linalg.norm(u - u_ref) / torch.linalg.norm(u_ref)))
        rts = [float(np.log2(errs[k] / errs[k + 1])) for k in range(len(errs) - 1)]
        print(f"RK{order}: errors {['%.2e' % e for e in errs]}, "
              f"rates {['%.2f' % r for r in rts]}")
        errors[order], rates[order] = errs, rts
    return {"errors": errors, "rates": rates, "u_ref": u_ref}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
