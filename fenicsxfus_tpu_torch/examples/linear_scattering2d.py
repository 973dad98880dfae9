"""2D plane-wave scattering off a penetrable cylinder against the exact
series: the port of ``examples/linear_scattering2d.py``. A heterogeneous
(DG-0 voxelised two-medium disc) linear run driven to steady state and
compared with the partial-wave expansion ``PenetrableExact2D`` (reference
``_analytical.py:118-190``) on a ring of 32 sensors at r = 2a. Lateral walls
are Neumann (the incident plane wave satisfies them exactly) and the
measurement window closes before scattered-wave wall reflections reach the
ring, so the free-field series applies."""

import numpy as np

from ..analysis.analytical import PenetrableExact2D
from ..core.mesh import create_rectangle, tag_boundaries
from ..models.linear import LinearSpectralExplicit
from ..scripts import cli, device_dtype


def main(epw=6, degree=4, ka=2 * np.pi, contrast=1.25, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    f0, p0 = 0.5e6, 60000.0
    c0, rho0 = 1500.0, 1000.0
    c1, rho1 = contrast * c0, 1.3 * rho0
    lam = c0 / f0
    a = ka / (2 * np.pi) * lam
    Lx, Ly = 8 * lam, 12 * lam
    ctr = np.array([4 * lam, 0.0])
    nx, ny = int(round(Lx / lam * epw)), int(round(Ly / lam * epw))
    mesh = create_rectangle((nx, ny), (0.0, -Ly / 2), (Lx, Ly / 2))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > Lx - 1e-9})
    mids = mesh.cell_vertices().mean(axis=1)
    inside = np.hypot(mids[:, 0] - ctr[0], mids[:, 1] - ctr[1]) < a
    c_cell = np.where(inside, c1, c0)
    rho_cell = np.where(inside, rho1, rho0)
    h = lam / epw
    spp = int(np.ceil(1.0 / (f0 * 0.5 * h / (c1 * degree**2))))
    dt = 1.0 / (f0 * spp)
    eqn = LinearSpectralExplicit(mesh, None, degree, c_cell, rho_cell, f0, p0, c0, 4, dt,
                                 dtype=dtype, device=device)
    eqn.init()
    T = 1.0 / f0
    th = np.linspace(0.0, 2 * np.pi, 32, endpoint=False)
    pts = np.stack([ctr[0] + 2 * a * np.cos(th), ctr[1] + 2 * a * np.sin(th)])
    u, v, t, times, ys = eqn.rk_record(0.0, depth * 11 * T, pts)
    ys = ys.cpu().numpy()
    # the steady window: the last two periods (after 9T at the whole horizon)
    amp = np.max(np.abs(ys[times > (11 * depth - 2) * T]), axis=0)
    ex = PenetrableExact2D(0.0, 2 * np.pi * f0, rho0, rho1, c0, c1, a)
    ref = p0 * np.abs(ex.total(np.stack([2 * a * np.cos(th), 2 * a * np.sin(th)])))
    err = float(np.linalg.norm(amp - ref) / np.linalg.norm(ref))
    print(f"ka={ka:.2f}  ring r=2a steady amplitudes vs exact series: "
          f"rel L2 err {err * 100:.2f}%")
    return {"u": u, "t": t, "times": times, "ys": ys, "amp": amp, "ref": ref, "err": err,
            "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
