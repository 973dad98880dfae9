"""Harmonic content of a recorded HITU run against weak-shock theory (the
port of the JAX package's ``benchmarks/hitu/harmonics.py``, on the port's
own ``drivers.hitu`` media and transducers; numpy on the host).

In the quasi-collimated pre-focal region a CW beam accumulates its 2nd
harmonic like a plane wave of slowly varying amplitude — the Fubini
expansion gives

    p2(x)/p1(x) = sigma_eff(x) / 2,
    sigma_eff(x) = (beta w0 / (rho0 c0^3)) * integral_0^x p1(s) ds,

valid for sigma_eff < ~1 (pre-shock; Hamilton & Blackstock ch. 4), with the
integral over the MEASURED fundamental profile p1(s). The gate compares the
focal-approach stations, 0.7·roc up to the fundamental's peak.

Run: ``python -m fenicsxfus_tpu_torch.drivers.harmonics <run.npz> [--json OUT]``
on a file written by ``hitu.run(..., out=...)`` (31 stations, the last 4
periods); exits 1 unless the gate passes.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .hitu import MEDIA, TRANSDUCERS


def harmonic_amplitudes(times, wave, f0, nharm=3):
    """|p| at k*f0 (k=1..nharm) from the steady tail via least-squares
    projection onto cos/sin at each harmonic — robust to a window that is
    not an exact integer number of samples per period."""
    t = np.asarray(times, np.float64)
    y = np.asarray(wave, np.float64)
    cols = []
    for k in range(1, nharm + 1):
        cols += [np.cos(2 * np.pi * k * f0 * t), np.sin(2 * np.pi * k * f0 * t)]
    A = np.stack(cols + [np.ones_like(t)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    return np.array([float(np.hypot(coef[2 * k], coef[2 * k + 1])) for k in range(nharm)])


def analyze(path, beta=None, pre_focal_max=None):
    """The harmonic table of the run in ``path`` (printed) and the Fubini
    gate over its focal-approach stations: {"rows", "gate", "meta"}."""
    d = np.load(path, allow_pickle=True)
    meta = json.loads(str(d["meta"]))
    f0 = float(meta["f0"])
    xs = np.asarray(d["sensor_x"], np.float64)
    times = np.asarray(d["times"], np.float64)
    ys = np.asarray(d["waveforms"], np.float64)  # [nt, ns]

    variant = meta.get("variant", "W-H131-WATER")
    tx = "H131" if "H131" in variant else "H101"
    medium = "LIVER" if "LIVER" in variant else "WATER"
    m = MEDIA[medium]
    c0, rho0 = m["c0"], m["rho0"]
    beta = beta if beta is not None else m["beta"]
    roc = TRANSDUCERS[tx]["roc"]
    pre_focal_max = pre_focal_max or 0.7 * roc

    H = np.stack([harmonic_amplitudes(times, ys[:, j], f0) for j in range(len(xs))])  # [ns, 3]
    p1, p2, p3 = H[:, 0], H[:, 1], H[:, 2]

    # sigma_eff from the measured p1 profile (trapezoid cumulative)
    w0 = 2 * np.pi * f0
    cum = np.concatenate([[0.0], np.cumsum(0.5 * (p1[1:] + p1[:-1]) * np.diff(xs))])
    sigma = beta * w0 / (rho0 * c0**3) * cum
    pred2 = sigma / 2.0 * p1

    rows = []
    print(f"{'x mm':>7} {'p1 kPa':>9} {'p2 kPa':>9} {'p2/p1':>7} "
          f"{'Fubini':>7} {'p3/p1':>7}  pre-focal<{pre_focal_max*1e3:.0f}mm")
    for j in range(len(xs)):
        meas = p2[j] / max(p1[j], 1e-12)
        pred = pred2[j] / max(p1[j], 1e-12)
        rows.append({"x": float(xs[j]), "p1": float(p1[j]), "p2": float(p2[j]),
                     "p3": float(p3[j]), "ratio2": float(meas), "fubini2": float(pred)})
        print(f"{xs[j]*1e3:7.1f} {p1[j]/1e3:9.1f} {p2[j]/1e3:9.1f} "
              f"{meas:7.4f} {pred:7.4f} {p3[j]/max(p1[j],1e-12):7.4f}")

    # Gate window: the smooth focal-approach region, 0.7*roc up to the
    # measured fundamental peak. The accumulated-Fubini form assumes slowly
    # varying amplitude (WKB): in the oscillatory near field the local ratio
    # is interference-dominated, and past the focal peak the plane-wave
    # accumulation overestimates (gain collapse + harmonic absorption).
    x_peak = xs[int(np.argmax(p1))]
    roc_lo = 0.7 * roc
    sel = (xs >= roc_lo) & (xs <= x_peak) & (sigma > 0.05)
    if not np.any(sel):
        print("no focal-approach stations selected; no gate evaluated")
        return {"rows": rows, "gate": None}
    meas = p2[sel] / p1[sel]
    pred = pred2[sel] / p1[sel]
    rel = np.abs(meas - pred) / pred
    pred3 = 3.0 * sigma[sel] ** 2 / 8.0
    meas3 = p3[sel] / p1[sel]
    rel3 = np.abs(meas3 - pred3) / np.maximum(pred3, 1e-12)
    worst = float(np.max(rel))
    med = float(np.median(rel))
    med3 = float(np.median(rel3))
    ok = bool(med < 0.35 and worst < 0.6 and med3 < 0.6)
    print(f"\nfocal-approach ({roc_lo*1e3:.1f}-{x_peak*1e3:.1f} mm) harmonic "
          f"growth vs Fubini: 2nd median rel dev {med*100:.1f}% (worst "
          f"{worst*100:.1f}%), 3rd median {med3*100:.1f}%  -> {'PASS' if ok else 'FAIL'}")
    return {
        "rows": rows,
        "gate": {"median_rel": med, "worst_rel": worst, "median_rel_3rd": med3, "pass": ok,
                 "stations": int(sel.sum()), "window_mm": [roc_lo * 1e3, x_peak * 1e3]},
        "meta": meta,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    res = analyze(args.artifact)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.json}")
    return 0 if res.get("gate") and res["gate"]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
