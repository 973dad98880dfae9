"""Run directly on a committed reference mesh (the XDMF/H5 read path): the
port of ``examples/linear_from_reference_mesh.py`` (reference driver
``python/examples/linear_planewave2d_1_exp``). Needs h5py and the mesh
file of that reference driver, given as ``mesh`` (``--mesh PATH``); without
it the script says so and returns None.

    python -m fenicsxfus_tpu_torch.examples.linear_from_reference_mesh --mesh PATH/mesh.xdmf
"""

from ..io.xdmf import read_mesh
from ..models.linear import LinearSpectralExplicit
from ..scripts import cli, device_dtype


def main(mesh=None, depth=1.0, dtype=None, device="cuda"):
    if mesh is None:
        print("no mesh given (--mesh PATH); skipping")
        return None
    device, dtype = device_dtype(device, dtype)
    mesh = read_mesh(mesh)
    f0, p0, c0, rho0 = 0.5e6, 60000.0, 1500.0, 1000.0
    degree = 4
    dt = 0.9 * mesh.h_min() / (c0 * degree**2)
    eqn = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                 dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk(0.0, depth * (0.12 / c0 + 4.0 / f0))
    max_u = float(u.abs().max())
    print(f"{eqn.number_of_dofs()} DOFs on reference mesh; max|u| = {max_u:.1f} Pa")
    return {"u": u, "t": tf, "max_u": max_u, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
