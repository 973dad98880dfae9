"""The hybrid (bowl-fitted) stiffness apply against the pure lattice apply
at production scale: the port of ``benchmarks/hybrid_speed.py``. Where does
the bowl-mesh solve's cost a step come from?

The hybrid split (``ops/operators.py::_setup_hybrid``) is K = K_uniform(the
whole lattice) + K_corr(the blend slab). On the H101 bowl-fitted mesh of
``drivers.hitu.build_bowl_model`` (linear, 0.5 MHz), fp32:

  lattice  the stiffness apply on a uniform box of the same grid (K1)
  hybrid   the whole hybrid apply on the bowl-fitted mesh (K1 + K6)
  band     the slab correction alone (K6, ``ops/band.py``: gather, the
           sum-factorised per-cell action, fold) on the slab rows

each timed by ``tools/variants.py::median_ms`` and ``device_ms`` beside its
bound (``tools/bounds.py``: the field, the coefficients and, for the band,
the slab's correction factors read once, the result written once).

    python -m fenicsxfus_tpu_torch.tools.hybrid_speed [--nx 80] [--degree 4]

On the CPU (``--device cpu``) the plain path runs and nothing is timed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.mesh import create_box
from ..drivers import hitu
from ..ops.operators import SEMOperators
from ..utils import resolve_device
from .bounds import floor_ms, nbytes, stencil_flops
from .variants import card_ms


def main(nx=80, degree=4, device="cuda") -> dict:
    device = resolve_device(device)
    model, h, dt, spp = hitu.build_bowl_model("W", "H101", "WATER", nx, degree=degree,
                                              f0=0.5e6, linear=True, device=device)
    ops = model.ops
    hy = ops.hybrid
    nd = ops.ndofs
    print(f"bowl-fitted H101 nx={nx} p={degree}: ndofs={nd / 1e6:.2f}M "
          f"blend slab: {hy['bx']} x-layers, {hy['nb']} cells "
          f"({hy['nb'] / ops.num_cells * 100:.1f}% of cells)")
    c_hyb = ops.stiff_coeff(1.0)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(nd), dtype=ops.dtype,
                        device=device)
    sx, gd = hy["slab_x"], ops.gdims
    rows = [x.view(gd)[:sx]]

    # pure lattice baseline: a uniform box with the same grid shape
    gs = model.mesh.grid_shape
    lo, hi = model.mesh.uniform_box
    ops_u = SEMOperators(create_box(tuple(gs), tuple(lo), tuple(hi)), degree, dtype=ops.dtype,
                         device=device)
    c_u = ops_u.stiff_coeff(1.0)

    lattice_bound = floor_ms(nbytes(x, c_u), nbytes(x), stencil_flops(gd, degree, 1, (0, 1, 2)))
    band_bound = floor_ms(nbytes(rows, c_hyb["hyb_b"], c_hyb["hyb_G"]), nbytes(rows), 0.0)
    paths = {
        "lattice": (lambda: ops_u.stiffness_apply([x], [c_u]), lattice_bound),
        "hybrid": (lambda: ops.stiffness_apply([x], [c_hyb]),
                   floor_ms(nbytes(x, c_hyb) + nbytes(rows), nbytes(x) + nbytes(rows),
                            stencil_flops(gd, degree, 1, (0, 1, 2)))),
        "band": (lambda: ops.band_correction_rows(rows, [c_hyb["hyb_b"]], c_hyb["hyb_G"]),
                 band_bound),
    }
    out = {}
    for name, (fn, bound) in paths.items():
        t = card_ms(fn, device)
        out[name] = {**t, **bound, "share": None if t["ms"] is None else bound["bound_ms"] / t["ms"]}
    t_lat = out["lattice"]["ms"]
    print(f"{'path':>10} {'ms/apply':>10} {'alone ms':>9} {'ns/DOF':>8} {'vs lattice':>11} "
          f"{'bound ms':>9} {'share':>6}")
    for name, r in out.items():
        if r["ms"] is None:
            print(f"{name:>10} {'not measured':>10} bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
            continue
        print(f"{name:>10} {r['ms']:10.3f} {r['device_ms']:9.3f} {r['ms'] * 1e6 / nd:8.3f} "
              f"{r['ms'] / t_lat:10.2f}x {r['bound_ms']:9.3f} {r['share']:6.3f}")
    # the hybrid apply against the lattice's plus the band's, on the same x
    y_h = ops.stiffness_apply([x], [c_hyb])
    y_l = ops_u.stiffness_apply([x], [c_u])
    y_l.view(gd)[:sx] += ops.band_correction_rows(rows, [c_hyb["hyb_b"]], c_hyb["hyb_G"])
    rel = float((y_h - y_l).abs().max() / y_l.abs().max())
    print(f"hybrid = lattice + band on the same x: max|d|/max|y| = {rel:.3e}")
    return {"ndofs": nd, "slab_cells": hy["nb"], "paths": out, "rel": rel,
            "gdims": tuple(gd)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=80)
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.nx, a.degree, a.device)
