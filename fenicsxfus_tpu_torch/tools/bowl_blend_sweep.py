"""The bowl mesh's blend and hold against its slab size and stable time
step: the port of ``benchmarks/bowl_blend_sweep.py``.

The hybrid (bowl-fitted) solve costs, per unit of simulated time, (a) the
slab correction K6 a stage, in proportion to the share of cells in the
blend slab, times (b) the steps, set by the stability clamp of the skewed
blend cells. Both follow ``create_bowl_box``'s ``blend`` (the depth over
which the bowl's deformation fades) and ``lateral_hold`` (the depth over
which the rim snap is held before it fades): a larger blend shears each cell
less (a larger dt) and makes the slab thicker; a larger hold keeps the
aperture sharp and makes the slab thicker too.

For the H101 geometry at the production domain (a 0.032 m, R 0.0632 m, 0.12
× 0.07 × 0.07 m; the default nx = 64: (64, 37, 37) cells, 5,705,657 DOF at
p = 4), for each blend/sag in ``blends`` and hold/blend in ``holds``, the
operators of the bowl mesh (fp32): the slab's share of the cells
(``ops.hybrid["nb"]``), ``blend_layers``, h_min/h, the ratio of
``utils.estimate_stable_dt`` (power iteration over K1 + K6 on the device)
to the uniform CFL scale h/(c0 p²), and the cost proxy (1/ratio)·(1 + 2 ·
share) (the band apply measured at 2-3 lattice cells a cell). A point whose
mesh ``create_bowl_box`` refuses (``ValueError``) is a row of its own. Ends
with the row of least proxy.

    python -m fenicsxfus_tpu_torch.tools.bowl_blend_sweep [--nx 64]
        [--blends 2,3,4,5] [--holds 0.25,0.5,1]

On the CPU (``--device cpu``) the same rows are computed there.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.bowl import create_bowl_box
from ..ops.operators import SEMOperators
from ..scripts import cli, device_dtype
from ..utils import estimate_stable_dt

# the H101 geometry at the production domain (drivers/hitu.py::TRANSDUCERS)
A, ROC, L, W = 0.032, 0.0632, 0.12, 0.07
C0, RHO0 = 1480.0, 1000.0


def point(nx: int, mb: float, mh: float, degree: int = 4, dtype=torch.float32,
          device="cuda") -> dict:
    """One row: blend = ``mb``·sag, hold = ``mh``·blend."""
    h = L / nx
    nyz = max(int(round(W / h)), 2)
    sag = ROC - np.sqrt(ROC**2 - A**2)
    blend = mb * sag
    t0 = time.perf_counter()
    try:
        mesh, _ = create_bowl_box((nx, nyz, nyz), (0.0, -W / 2, -W / 2), (L, W / 2, W / 2), ROC,
                                  A, blend=blend, lateral_hold=mh * blend)
    except ValueError as e:
        return {"mb": mb, "mh": mh, "failed": f"{type(e).__name__}: {str(e)[:60]}"}
    ops = SEMOperators(mesh, degree, dtype=dtype, device=device)
    build_s = time.perf_counter() - t0
    frac = ops.hybrid["nb"] / mesh.num_cells if ops.hybrid else 0.0
    t0 = time.perf_counter()
    dt_star = estimate_stable_dt(ops, C0, RHO0, rk_order=4)
    dt_s = time.perf_counter() - t0
    ratio = dt_star / (h / (C0 * degree**2))
    return {"mb": mb, "mh": mh, "frac": frac, "layers": int(mesh.blend_layers),
            "hmin_h": mesh.h_min() / h, "ratio": ratio, "proxy": (1.0 / ratio) * (1.0 + 2.0 * frac),
            "ndofs": ops.ndofs, "build_s": build_s, "dt_s": dt_s}


def row_text(r: dict) -> str:
    if "failed" in r:
        return f"{r['mb']:9.2f} {r['mh']:10.2f}   build failed: {r['failed']}"
    return (f"{r['mb']:9.2f} {r['mh']:10.2f} {r['frac'] * 100:5.1f}% {r['layers']:6d} "
            f"{r['hmin_h']:7.3f} {r['ratio']:8.3f} {r['proxy']:10.3f}   (mesh and operators "
            f"{r['build_s']:.2f} s, estimate_stable_dt {r['dt_s']:.2f} s)")


def main(nx: int = 64, blends: str = "2,3,4,5", holds: str = "0.25,0.5,1", degree: int = 4,
         dtype=None, device="cuda") -> dict:
    """The rows in the JAX script's order (blend outer, hold inner) and the
    best one."""
    dev, dtype = device_dtype(device, dtype, cpu_dtype=torch.float32)
    h = L / nx
    sag = ROC - np.sqrt(ROC**2 - A**2)
    print(f"H101 nx={nx} p={degree}: h={h * 1e3:.2f} mm sag={sag * 1e3:.2f} mm uniform-CFL dt "
          f"scale {h / (C0 * degree**2):.3e}, {dtype} on {dev}")
    print(f"{'blend/sag':>9} {'hold/blend':>10} {'slab%':>6} {'layers':>6} {'hmin/h':>7} "
          f"{'dt*/dtu':>8} {'cost-proxy':>10}")
    rows = []
    for mb in (float(b) for b in blends.split(",")):
        for mh in (float(s) for s in holds.split(",")):
            r = point(nx, mb, mh, degree, dtype, dev)
            print(row_text(r), flush=True)
            rows.append(r)
    built = [r for r in rows if "failed" not in r]
    best = min(built, key=lambda r: r["proxy"]) if built else None
    if best:
        print(f"\nbest proxy: blend={best['mb']}*sag hold={best['mh']}*blend (slab "
              f"{best['frac'] * 100:.1f}%, dt ratio {best['ratio']:.3f})")
    return {"nx": nx, "rows": rows, "best": best}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
