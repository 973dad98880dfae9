"""2D linear planar-transducer problem, explicit RK: the port of
``examples/linear_planar2d.py`` (reference ``python/examples/linear_planar2d_1_exp``):
a finite-width transducer strip on the x=0 boundary (the rest of that face
is a rigid baffle), Sommerfeld ABC on the remaining faces. Marches in 16
frames and writes them as a field movie (temporal XDMF, the reference's VTX
``.bp`` analogue) where h5py imports, and the last frame as ``{out}.npz``."""

import numpy as np

from ..core.mesh import create_rectangle, tag_boundaries
from ..io.xdmf import write_movie
from ..models.linear import LinearSpectralExplicit
from ..scripts import cli, device_dtype
from ._output import have_h5py, save


def main(epw=4, degree=4, out="linear_planar2d", depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 0.5e6, 60000.0
    c0, rho0 = 1500.0, 1000.0
    L = 0.12
    a = 0.01  # transducer half-width (m)
    lmbda = c0 / f0
    nx = int(epw * L / lmbda + 1)
    mesh = create_rectangle((nx, nx), (0, -L / 2), (L, L / 2))
    eps = 1e-9

    def src(x):
        return (x[0] < eps) & (np.abs(x[1]) <= a)

    def abc(x):
        return (x[0] > L - eps) | (np.abs(x[1]) > L / 2 - eps)

    tag_boundaries(mesh, {1: src, 2: abc})
    h = L / nx
    dt_cfl = 0.9 * h / (c0 * degree**2)
    spp = int(1 / f0 / dt_cfl + 1)
    dt = 1 / f0 / spp
    eqn = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                 dtype=dtype, device=device)
    eqn.init()
    tend = depth * (L / c0 + 4.0 / f0)
    n_frames = 16
    if have_h5py():
        times = write_movie(eqn, 0.0, tend, f"{out}.xdmf", n_frames=n_frames, name="pressure")
    else:  # the movie's frames, marched alike, unwritten
        print("h5py does not import here: no XDMF movie written")
        t = 0.0
        for tn in np.linspace(0.0, tend, n_frames + 1)[1:]:
            eqn.rk(t, float(tn))
            t = eqn.t
        times = np.linspace(0.0, tend, n_frames + 1)
    max_u = float(eqn.u_n.abs().max())
    print(f"DOFs {eqn.number_of_dofs()}, {len(times)} frames to t={eqn.t:.3e}, "
          f"max|u| = {max_u:.1f} Pa")
    paths = save(out, eqn.ops, eqn.u_n, eqn.t, xdmf=False)
    if have_h5py():
        print(f"wrote {out}.xdmf / {out}.h5")
        paths += [f"{out}.xdmf", f"{out}.h5"]
    return {"u": eqn.u_n, "t": eqn.t, "frames": len(times), "max_u": max_u, "paths": paths,
            "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
