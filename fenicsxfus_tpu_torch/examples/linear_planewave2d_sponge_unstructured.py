"""2D linear planewave on an unstructured mesh with a sponge-layer absorber:
the port of ``examples/linear_planewave2d_sponge_unstructured.py`` (reference
``python/examples/linear_planewave2d_3``): the reference's committed
unstructured quad mesh, first-order Sommerfeld ABC plus a spatially ramped
δ(x) sponge pad (``_experimental.py:715-984``). Needs h5py and the mesh
file of that reference driver, given as ``mesh`` (``--mesh PATH``); without
it the script says so and returns None.

    python -m fenicsxfus_tpu_torch.examples.linear_planewave2d_sponge_unstructured --mesh PATH/mesh.xdmf
"""

import numpy as np

from ..io.xdmf import read_mesh
from ..models.experimental import LinearSpectralSponge
from ..scripts import cli, device_dtype
from ..utils import compute_diffusivity_of_sound


def main(mesh=None, degree=4, depth=1.0, dtype=None, device="cuda"):
    if mesh is None:
        print("no mesh given (--mesh PATH); skipping")
        return None
    device, dtype = device_dtype(device, dtype)
    mesh = read_mesh(mesh)
    f0, p0 = 0.5e6, 60000.0
    c0, rho0 = 1500.0, 1000.0
    delta0 = compute_diffusivity_of_sound(2.0 * np.pi * f0, c0, 1.0)
    L = 0.12
    h = mesh.h_min()
    dt_cfl = 0.4 * h / (c0 * degree**2)
    spp = int(1 / f0 / dt_cfl + 1)
    dt = 1 / f0 / spp
    eqn = LinearSpectralSponge(mesh, None, degree, c0, rho0, delta0, f0, p0, c0,
                               sponge_start=L, dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk4(0.0, depth * (L / c0 + 4.0 / f0), dt)
    un = u.abs().cpu().numpy()
    x = eqn.ops.space.dof_coords[:, 0]
    body = float(un[x < L].max())
    pad_end = float(un[x > x.max() - 0.25 * (x.max() - L)].max())
    print(f"DOFs {eqn.number_of_dofs()} (unstructured, {mesh.num_cells} cells): "
          f"max|u| body {body:.1f} Pa, sponge tail {pad_end:.1f} Pa (absorbed)")
    return {"u": u, "t": tf, "body": body, "pad_end": pad_end, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
