"""Focused bowl transducer on a true curved-facet mesh (H101-like): the port
of ``examples/linear_bowl3d.py``. The reference drives its HITU benchmarks
from gmsh meshes with the bowl surface fitted into the boundary
(``cpp/fenicsx-sf-fastor/benchmarks/HITU/W-H101-WATER/main.cpp:33-52``);
``create_bowl_box`` generates the equivalent geometry natively and the hybrid
operator runs the lattice kernels on the uniform bulk (on the card K2 with
its band operand) with the slab correction K6 on the blend slab only. The run
reports the focal gain against the O'Neil (1949) axial solution."""

import numpy as np

from ..analysis.analytical import oneil_axial_amplitude
from ..core.bowl import create_bowl_box
from ..models.linear import LinearSpectralExplicit
from ..scripts import cli, device_dtype


def main(nx=48, degree=4, depth=1.0, dtype=None, device="cuda"):
    device, dtype = device_dtype(device, dtype)
    # H101-like geometry at a reduced frequency so the default nx resolves it
    f0, p0 = 0.25e6, 60000.0
    c0, rho0 = 1500.0, 1000.0
    a, roc = 0.032, 0.0632
    L, W = 0.12, 0.07
    h = L / nx
    nyz = max(int(round(W / h)), 2)
    mesh, focus = create_bowl_box((nx, nyz, nyz), (0.0, -W / 2, -W / 2), (L, W / 2, W / 2),
                                  roc, a)
    # 0.3: skewed blend-band cells raise the spectral radius beyond what
    # h_min implies; 0.4 is marginally unstable in fp32 at coarse nx
    dt = 0.3 * mesh.h_min() / (c0 * degree**2)
    eqn = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                 dtype=dtype, device=device)
    eqn.init()
    lam = c0 / f0
    hybrid = eqn.ops.hybrid is not None
    print(f"bowl mesh: {eqn.number_of_dofs() / 1e6:.2f}M DOFs  {lam / h:.1f} elems/wavelength  "
          f"hybrid={'on' if hybrid else 'off'}")
    t1 = depth * ((focus[0] + 3 * lam) / c0 + 6.0 / f0)
    eqn.rk(0.0, t1)
    xs = np.linspace(0.02, 0.11, 61)
    pts = np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)])
    u, v, t, times, ys = eqn.rk_record(t1, t1 + depth / f0, pts)
    ys = ys.cpu().numpy()
    amp = np.max(np.abs(ys), axis=0)
    k = 2 * np.pi * f0 / c0
    depth_cap = roc - np.sqrt(roc**2 - a**2)
    ref = oneil_axial_amplitude(xs + depth_cap, a, roc, k, p0)
    i_pk, i_rf = int(np.argmax(amp)), int(np.argmax(ref))
    gain_err = float(abs(amp[i_pk] - ref[i_rf]) / ref[i_rf])
    print(f"focal |p|: model {amp[i_pk] / 1e3:.1f} kPa @ {xs[i_pk] * 1e3:.1f} mm, "
          f"O'Neil {ref[i_rf] / 1e3:.1f} kPa @ {xs[i_rf] * 1e3:.1f} mm "
          f"(gain err {gain_err * 100:.1f}%)")
    return {"u": u, "t": t, "times": times, "ys": ys, "xs": xs, "amp": amp, "ref": ref,
            "gain_err": gain_err, "x_peak": float(xs[i_pk]), "hybrid": hybrid, "model": eqn}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
