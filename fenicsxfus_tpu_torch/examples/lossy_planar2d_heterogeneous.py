"""2D heterogeneous (water|bone) lossy planar problem: the port of
``examples/lossy_planar2d_heterogeneous.py`` (reference
``python/examples/lossy_planar2d_4_exp``): two-medium DG-0 material fields set
from cell regions, water for x < x_interface and cortical-bone-like
parameters beyond."""

import numpy as np

from ..core.mesh import create_rectangle, tag_boundaries
from ..models.lossy import LossySpectralExplicit
from ..scripts import cli, device_dtype
from ..utils import compute_diffusivity_of_sound


def main(epw=4, degree=4, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 0.5e6, 60000.0
    c_water, rho_water = 1500.0, 1000.0
    c_bone, rho_bone = 2800.0, 1850.0
    alpha_bone_dB = 400.0
    L = 0.12
    x_int = 0.06
    nx = int(epw * L * f0 / c_water + 1)
    mesh = create_rectangle((nx, nx), (0, 0), (L, L))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    # DG0 material fields from cell midpoints (the reference sets them from
    # cell tags; midpoint classification is equivalent for this geometry)
    mids = mesh.cell_vertices().mean(axis=1)
    bone = mids[:, 0] >= x_int
    c0 = np.where(bone, c_bone, c_water)
    rho0 = np.where(bone, rho_bone, rho_water)
    delta0 = np.where(
        bone, compute_diffusivity_of_sound(2 * np.pi * f0, c_bone, alpha_bone_dB), 0.0)
    h = L / nx
    dt = 0.35 * h / (c_bone * degree**2)
    eqn = LossySpectralExplicit(mesh, None, degree, c0, rho0, delta0, f0, p0, c_water, 4, dt,
                                dtype=dtype, device=device)
    eqn.init()
    u, v, tf = eqn.rk(0.0, depth * (L / c_water + 2.0 / f0))
    un = u.abs().cpu().numpy()
    coords = eqn.ops.space.dof_coords
    in_bone = float(un[coords[:, 0] > x_int + 0.01].max())
    in_water = float(un[coords[:, 0] < x_int - 0.01].max())
    print(f"max|u| water: {in_water:.1f} Pa, bone: {in_bone:.1f} Pa (attenuated)")
    return {"u": u, "t": tf, "in_water": in_water, "in_bone": in_bone, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
