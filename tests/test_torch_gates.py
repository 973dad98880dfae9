"""Physics gates of the port's lossy and Westervelt models in the 3D
channel ``create_box((n, 1, 1))`` with the source at x=0 and the ABC at x=L:
exactly the 1D problem, so the reference's 1D gates apply
(``tests/test_models_1d.py:87-148``): lossy against the damped plane wave
< 1e-2 at (p, epw) = (4, 4), Westervelt against the Fubini series < 1e-1 at
(4, 8). fp64, the fused step (plain K2 on the CPU).
"""

import numpy as np
import torch

from fenicsxfus_tpu_torch import (
    LossySpectralExplicit,
    WesterveltSpectralExplicit,
    compute_diffusivity_of_sound,
    create_box,
    tag_boundaries,
)
from fenicsxfus_tpu_torch.analysis.analytical import damped_planewave, fubini
from fenicsxfus_tpu_torch.analysis.error import relative_l2_error

torch.set_num_threads(1)

F0 = 10.0  # source frequency (Hz)
U0 = 1.0  # velocity amplitude (m/s)
C0 = 1.0  # speed of sound (m/s)
L = 1.0  # domain length (m)


def _channel(epw: int):
    nx = int(epw * (L / (C0 / F0)) + 1)
    mesh = create_box((nx, 1, 1), (0, 0, 0), (L, 0.1, 0.1))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    return mesh, L / nx


def test_lossy_damped_planewave():
    degree, epw = 4, 4
    rho0 = 4.0
    p0 = rho0 * C0 * U0
    alphadB = 5.0
    alphaNp = alphadB / 20 * np.log(10)
    delta0 = compute_diffusivity_of_sound(2 * np.pi * F0, C0, alphadB)
    mesh, h = _channel(epw)
    dt = 0.5 * h / (C0 * degree**2)
    eqn = LossySpectralExplicit(mesh, None, degree, C0, rho0, delta0, F0, p0, C0, 4, dt,
                                dtype=torch.float64, device="cpu")
    assert eqn.step_kind == "fused"
    u, _, tf = eqn.rk(0.0, L / C0 + 16.0 / F0)
    err = relative_l2_error(eqn.ops, u, lambda x: damped_planewave(x[0], tf, C0, F0, p0, alphaNp))
    assert err < 1e-2, err


def test_westervelt_fubini():
    degree, epw = 4, 8
    rho0, beta0 = 1.0, 0.01
    p0 = rho0 * C0 * U0
    mesh, h = _channel(epw)
    dt = 0.9 * h / (C0 * degree**2)
    eqn = WesterveltSpectralExplicit(mesh, None, degree, C0, rho0, 0.0, beta0, F0, p0, C0, 4, dt,
                                     dtype=torch.float64, device="cpu")
    assert eqn.step_kind == "fused"
    u, _, tf = eqn.rk(0.0, L / C0 + 8.0 / F0)
    err = relative_l2_error(eqn.ops, u, lambda x: fubini(x[0], tf, C0, F0, p0, rho0, beta0))
    assert err < 1e-1, err
