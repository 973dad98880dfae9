"""The JAX suite's gates for the experimental models
(``tests/test_experimental.py``), through the PyTorch port on the CPU in
fp64: Newmark 1D < 0.05, adaptive linear < 1e-3, adaptive Westervelt
< 1e-1, the S2 window (near > 10 x far), the sponge's damping (deep <
0.5 x inside), and the sponge on an unstructured mesh equal to the lattice
run to 1e-10 (at the JAX test's 20 x 5 cells and 60 steps; that suite marks
it slow, here it takes about 2 s).
"""

import numpy as np
import torch

import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.analysis.analytical import fubini, planewave
from fenicsxfus_tpu_torch.analysis.error import relative_l2_error
from fenicsxfus_tpu_torch.core.mesh import Mesh
from fenicsxfus_tpu_torch.models.experimental import heaviside_window

torch.set_num_threads(1)

F0, C0, L = 10.0, 1.0, 1.0


def _mesh_1d(epw):
    nx = int(epw * (L * F0 / C0) + 1)
    mesh = ft.create_interval(nx, 0.0, L)
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    return mesh, L / nx


def test_newmark_1d():
    degree, rho0 = 4, 4.0
    p0 = rho0 * C0
    mesh, h = _mesh_1d(4)
    dt = 0.25 * h / (C0 * degree**2)  # Newmark-β needs smaller dt for accuracy
    eqn = ft.LinearSpectralNewmark(mesh, None, degree, C0, rho0, F0, p0, C0, dt, device="cpu")
    eqn.init()
    u, v, w, tf = eqn.newmark(0.0, L / C0 + 16.0 / F0)
    err = relative_l2_error(eqn.ops, u, lambda x: planewave(x[0], tf, C0, F0, p0))
    assert err < 0.05, err  # same gate as the implicit reference solvers


def test_adaptive_linear_1d():
    rho0 = 4.0
    p0 = rho0 * C0
    mesh, h = _mesh_1d(4)
    eqn = ft.LinearSpectralAdaptive(mesh, None, 4, C0, rho0, F0, p0, C0, device="cpu",
                                    atol=1e-9, rtol=1e-9)
    eqn.init()
    u, v, tf, steps = eqn.rk(0.0, L / C0 + 16.0 / F0)
    assert steps > 0
    err = relative_l2_error(eqn.ops, u, lambda x: planewave(x[0], tf, C0, F0, p0))
    assert err < 1e-3, err


def test_adaptive_westervelt_1d():
    rho0, beta0 = 1.0, 0.01
    p0 = rho0 * C0
    mesh, h = _mesh_1d(8)
    eqn = ft.WesterveltSpectralAdaptive(mesh, None, 4, C0, rho0, 0.0, beta0, F0, p0, C0,
                                        device="cpu", atol=1e-8, rtol=1e-8)
    eqn.init()
    u, v, tf, steps = eqn.rk(0.0, L / C0 + 8.0 / F0)
    err = relative_l2_error(eqn.ops, u, lambda x: fubini(x[0], tf, C0, F0, p0, rho0, beta0))
    assert err < 1e-1, err


def test_s2_windowed_source_2d():
    """The windowed source should only excite the strip |y-center| small."""
    mesh = ft.create_rectangle((20, 10), (0, -0.5), (1.0, 0.5))
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
    eqn = ft.LinearSpectralS2(mesh, None, 3, C0, 1.0, F0, 1.0, C0,
                              source_profile=heaviside_window(-0.1, 0.1, axis=1),
                              dtype=torch.float64, device="cpu")
    eqn.init()
    h = 1.0 / 20
    u, v, tf = eqn.rk4(0.0, 0.2, 0.5 * h / (C0 * 9))
    coords = eqn.ops.space.dof_coords
    un = np.abs(u.numpy())
    near = un[(np.abs(coords[:, 1]) < 0.08) & (coords[:, 0] < 0.15)]
    far = un[(np.abs(coords[:, 1]) > 0.35) & (coords[:, 0] < 0.15)]
    assert near.max() > 10 * max(far.max(), 1e-12)


def test_sponge_damps_outgoing_wave():
    """With a sponge pad the field in the pad decays; the solver stays stable."""
    mesh = ft.create_interval(40, 0.0, 0.2)
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 0.2 - 1e-12})
    f0, c0 = 0.5e6, 1500.0
    delta0 = 2 * c0 / (2 * np.pi * f0) * 4.0  # strong damping scale
    dt = 0.25 * (0.2 / 40) / (c0 * 16)
    eqn = ft.LinearSpectralSponge(mesh, None, 4, c0, 1.0, delta0, f0, 1.0, c0,
                                  sponge_start=0.12, dtype=torch.float64, device="cpu")
    eqn.init()
    u, v, tf = eqn.rk4(0.0, 0.25 / f0 * 200, dt)
    un = np.abs(u.numpy())
    coords = eqn.ops.space.dof_coords[:, 0]
    assert np.all(np.isfinite(un))
    inside = un[coords < 0.10].max()
    deep = un[coords > 0.19].max()
    assert deep < 0.5 * inside  # wave decays through the sponge pad


def test_sponge_on_unstructured_mesh_matches_lattice():
    """Sponge model on a scrambled-vertex (no-lattice) mesh == the
    structured-lattice solution, fields compared by DOF coordinates."""
    f0, p0, c0, rho0 = 0.5e6, 1.0, 1500.0, 1.0
    delta0 = 2 * c0 / (2 * np.pi * f0) * 4.0
    Lx, Ly = 0.2, 0.05
    mesh_s = ft.create_rectangle((20, 5), (0, 0), (Lx, Ly))
    rng = np.random.default_rng(3)
    perm = rng.permutation(mesh_s.num_vertices)
    v2 = np.empty_like(mesh_s.vertices)
    v2[perm] = mesh_s.vertices
    mesh_u = Mesh(dim=2, vertices=v2, cells=perm[mesh_s.cells])
    dt = 0.25 * (Lx / 20) / (c0 * 16)
    sols = []
    for mesh in (mesh_s, mesh_u):
        ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > Lx - 1e-12})
        eqn = ft.LinearSpectralSponge(mesh, None, 4, c0, rho0, delta0, f0, p0, c0,
                                      sponge_start=0.12, dtype=torch.float64, device="cpu")
        eqn.init()
        u, v, tf = eqn.rk4(0.0, 60 * dt, dt)
        coords = eqn.ops.space.dof_coords
        order = np.lexsort((coords[:, 1], coords[:, 0]))
        sols.append(u.numpy()[order])
    assert (eqn.ops.lattice is None) and sols[1].shape == sols[0].shape
    scale = max(np.abs(sols[0]).max(), 1e-30)
    assert scale > 0 and np.abs(sols[1] - sols[0]).max() / scale < 1e-10
