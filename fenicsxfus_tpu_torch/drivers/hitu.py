"""HITU focused-bowl benchmark driver (port of ``benchmarks/hitu/common.py``).

The reference's HITU drivers (``cpp/fenicsx-sf-fastor/benchmarks/HITU/
{W-H101,W-H131}-{WATER,LIVER}`` and the lossy ``cpp/fenicsx-sf-naive/
benchmarks/HITU/V-H131-WATER``): Sonic Concepts H101 (64 mm aperture,
63.2 mm radius of curvature) and H131 (33 mm aperture, 35 mm ROC) bowl
transducers driving Westervelt or lossy propagation in water or liver at
1.1 MHz. The bowl is either an equivalent phased flat aperture
(``models/focused.py``, the default) or, with ``bowl=True``, the curved
spherical cap itself fitted into the mesh (``core/bowl.py``) and driven
through its facet tag with a plain source, as the reference drives its gmsh
meshes (``W-H101-WATER/main.cpp:33-52``); both are checked against the
O'Neil (1949) axial solution (``validate_oneil``, ``validate_bowl_mesh``).
By default the frequency is scaled to 0.5 MHz so that a resolved mesh fits
one card; ``full=True`` selects the true 1.1 MHz.

Run on the card, e.g. ``python -m fenicsxfus_tpu_torch.drivers.hitu W H101 WATER``
(``--bowl`` for the bowl-fitted mesh, ``--oneil`` for the O'Neil check of
either, ``--check`` a committed run to hold the result against). The
reference-scale problem of ``W-H131-WATER/main.cpp`` (1.1 MHz, nx = 164,
85,620,897 DOF, 7488 RK4 steps) is ``W H131 WATER --full --nx 164 --check
benchmarks/hitu/results/w_h131_water_full11MHz.npz``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..analysis.analytical import oneil_axial_amplitude
from ..analysis.timing import snapshot, span, traced, tracing
from ..core.bowl import create_bowl_box
from ..core.mesh import create_box, tag_boundaries
from ..models.focused import WesterveltSpectralFocused
from ..models.westervelt import WesterveltSpectralExplicit
from ..utils import estimate_stable_dt, init_device

# transducer geometry: half-aperture a, radius of curvature, domain length
# and width (Groth et al. 2021; domain lengths from the reference mains:
# W-H101-*: 0.12 m, W-H131-*: 0.08 m)
TRANSDUCERS = {
    "H101": {"a": 0.032, "roc": 0.0632, "L": 0.12, "W": 0.07},
    "H131": {"a": 0.0165, "roc": 0.035, "L": 0.08, "W": 0.044},
}

# media: c0 m/s, rho0 kg/m^3, beta, attenuation dB/m
# WATER: W-H101-WATER/main.cpp:33-44; LIVER: W-H101-LIVER/main.cpp:33-47
MEDIA = {
    "WATER": {"c0": 1480.0, "rho0": 1000.0, "beta": 3.5, "att_dB": 0.2},
    "LIVER": {"c0": 1590.0, "rho0": 1060.0, "beta": 4.4, "att_dB": 90.0},
}

F0_FULL = 1.1e6  # source frequency (Hz), all reference HITU mains

# source velocities u0 (m/s); p0 = rho c u0 (reference main.cpp:36-37).
# The W- values are the fastor drivers'; V-H131-WATER (lossy) uses the
# sf-naive value.
SOURCE_VELOCITY = {
    ("W", "H101", "WATER"): 0.13984880278551745,
    ("W", "H101", "LIVER"): 0.1853331526917232,
    ("W", "H131", "WATER"): 0.38557513826589934,
    ("W", "H131", "LIVER"): 0.3613169918914827,
    ("V", "H131", "WATER"): 0.2726428,
}


def _medium(kind: str, tx: str, medium: str, f0: float, linear: bool):
    """(c0, ρ0, p0, δ0, β0) of variant ``kind`` ("W" Westervelt, "V" lossy)
    on transducer ``tx`` in ``medium`` at ``f0``; ``linear=True`` zeroes β
    and δ (O'Neil check)."""
    m = MEDIA[medium]
    c0, rho0 = m["c0"], m["rho0"]
    p0 = rho0 * c0 * SOURCE_VELOCITY[(kind, tx, medium)]
    alphaNp = m["att_dB"] / 20 * np.log(10)
    delta0 = 0.0 if linear else 2 * alphaNp * c0**3 / (2 * np.pi * f0) ** 2
    beta0 = 0.0 if (linear or kind == "V") else m["beta"]
    return c0, rho0, p0, delta0, beta0


def _cfl_dt(cfl: float, h: float, c0: float, degree: int, f0: float):
    """The CFL dt rounded to whole steps per period (reference
    main.cpp:108-111): (dt, steps per period)."""
    spp = int(1 / f0 / (cfl * h / (c0 * degree**2))) + 1
    return 1 / f0 / spp, spp


@traced("fus.setup", sync=True)
def build_model(kind: str, tx: str, medium: str, nx: int, degree: int = 4,
                f0: float | None = None, cfl: float = 0.4, dtype=None,
                linear: bool = False, nyz: int | None = None, device="cuda"):
    """Focused model for variant ``kind`` ("W" Westervelt, "V" lossy) on
    transducer ``tx`` in ``medium``, on an nx × nyz × nyz box (cubic cells
    unless ``nyz`` is given). ``linear=True`` zeroes β and δ (O'Neil check).
    Returns (model, h, dt, steps per period)."""
    dtype = dtype or torch.float32
    g = TRANSDUCERS[tx]
    f0 = f0 or F0_FULL
    c0, rho0, p0, delta0, beta0 = _medium(kind, tx, medium, f0, linear)

    L, W = g["L"], g["W"]
    h = L / nx
    nyz = nyz or max(int(round(W / h)), 2)
    a = g["a"]
    eps = 1e-9
    with span("fus.setup.mesh"):
        mesh = create_box((nx, nyz, nyz), (0.0, -W / 2, -W / 2), (L, W / 2, W / 2))
        tag_boundaries(mesh, {1: lambda x: (x[0] < eps) & (np.hypot(x[1], x[2]) <= a)},
                       default=2)
    dt, spp = _cfl_dt(cfl, h, c0, degree, f0)

    init_device(device)
    with span("fus.setup.assembly"):
        model = WesterveltSpectralFocused(
            mesh, None, degree, c0, rho0, delta0, beta0, f0, p0, c0, 4, dt,
            aperture_radius=a, focal_distance=g["roc"], center=np.array([0.0, 0.0, 0.0]),
            dtype=dtype, device=device,
        )
        model.init()
    return model, h, dt, spp


def bowl_mesh(tx: str, nx: int):
    """The bowl-fitted mesh of transducer ``tx`` with ``nx`` axial cells
    (``create_bowl_box``; blend depth ``FUS_BOWL_BLEND_MULT`` = 2 sagittae
    and lateral hold ``FUS_BOWL_HOLD_MULT`` = 0.25 blend lengths by
    default): (mesh, uniform axial spacing h)."""
    g = TRANSDUCERS[tx]
    L, W = g["L"], g["W"]
    h = L / nx
    nyz = max(int(round(W / h)), 2)
    sag = g["roc"] - np.sqrt(g["roc"] ** 2 - g["a"] ** 2)
    blend = float(os.environ.get("FUS_BOWL_BLEND_MULT", "2.0")) * sag
    hold = float(os.environ.get("FUS_BOWL_HOLD_MULT", "0.25")) * blend
    mesh, _ = create_bowl_box((nx, nyz, nyz), (0.0, -W / 2, -W / 2), (L, W / 2, W / 2),
                              g["roc"], g["a"], blend=blend, lateral_hold=hold)
    return mesh, h


@traced("fus.setup", sync=True)
def build_bowl_model(kind: str, tx: str, medium: str, nx: int, degree: int = 4,
                     f0: float | None = None, cfl: float = 0.3, dtype=None,
                     linear: bool = False, device="cuda"):
    """Like ``build_model``, on the bowl-fitted mesh (``core/bowl.py``): the
    transducer is the set of curved facets of the spherical cap, driven
    with a plain uniform source (no phasing, no obliquity weight), so the
    focusing comes from the geometry. The model is the Westervelt one on the
    hybrid operator path. The blend depth and the lateral hold default to
    ``FUS_BOWL_BLEND_MULT`` = 2 sagittae and ``FUS_BOWL_HOLD_MULT`` = 0.25
    blend lengths (the JAX package's production defaults), and dt, the CFL
    rule on the uniform spacing, is clamped by the measured operator
    spectrum (``utils.estimate_stable_dt``). Returns (model, h, dt, steps
    per period)."""
    dtype = dtype or torch.float32
    f0 = f0 or F0_FULL
    c0, rho0, p0, delta0, beta0 = _medium(kind, tx, medium, f0, linear)
    with span("fus.setup.mesh"):
        mesh, h = bowl_mesh(tx, nx)

    # the CFL rule on the uniform spacing; stability on the deformed cells
    # is the measured spectrum's (below)
    dt, spp = _cfl_dt(cfl, h, c0, degree, f0)

    init_device(device)
    with span("fus.setup.assembly"):
        model = WesterveltSpectralExplicit(mesh, None, degree, c0, rho0, delta0, beta0, f0, p0,
                                           c0, 4, dt, dtype=dtype, device=device)
        model.init()
    dt_star = estimate_stable_dt(model.ops, c0, rho0, rk_order=4)
    if dt_star < dt:
        spp = int(1 / f0 / dt_star) + 1
        dt = 1 / f0 / spp
        model.dt = dt
    return model, h, dt, spp


def axial_points(tx: str, n: int = 161):
    L = TRANSDUCERS[tx]["L"]
    x = np.linspace(0.0, L, n)
    return np.stack([x, np.zeros_like(x), np.zeros_like(x)])


def steady_amplitude(times, ys, f0, n_periods=2):
    """Peak |u| per sensor over the last ``n_periods`` source periods
    (``ys`` [n_steps, n_sensors], host)."""
    tail = times > times[-1] - n_periods / f0
    return np.max(np.abs(ys[tail]), axis=0)


def _synchronize(model):
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def _record_axial(model, tx, tf):
    """``rk_record`` of the axial sensors from t = 0 to ``tf``:
    (x, times, ys on the host, solve seconds)."""
    pts = axial_points(tx)
    _synchronize(model)
    t0 = time.perf_counter()
    _, _, _, times, ys = model.rk_record(0.0, tf, pts)
    ys = ys.cpu().numpy()  # waits for the device
    return pts[0], times, ys, time.perf_counter() - t0


@dataclass
class HituRun:
    """One HITU run: axial positions, steady amplitude, and what it cost."""

    x: np.ndarray
    amplitude: np.ndarray
    model: WesterveltSpectralFocused
    setup_s: float  # mesh, host assembly and upload
    solve_s: float  # the time march with in-loop recording
    nsteps: int
    # host seconds of the set-up's phases (``split_setup``)
    setup_split: dict | None = None


SETUP_PHASES = ("library", "mesh", "context", "operators", "assembly", "source", "upload",
                "stable_dt")


def split_setup(before: dict, after: dict) -> dict:
    """The self seconds of each ``fus.setup.<phase>`` span between two
    ``analysis.timing.snapshot()``s, and under ``"other"`` the self seconds of
    ``fus.setup``, the entry's time that no phase covers."""
    def self_s(name):
        return after.get(name, {}).get("self_s", 0.0) - before.get(name, {}).get("self_s", 0.0)

    split = {ph: self_s(f"fus.setup.{ph}") for ph in SETUP_PHASES}
    split["other"] = self_s("fus.setup")
    return split


def run(kind: str, tx: str, medium: str, nx: int = 80, degree: int = 4,
        full: bool = False, f0: float | None = None, out: str | None = None,
        final_time: float | None = None, dtype=None, bowl: bool = False,
        nyz: int | None = None, device="cuda") -> HituRun:
    """Run one HITU variant and read the steady axial amplitude from 161
    on-axis sensors; ``bowl=True`` on the bowl-fitted mesh
    (``build_bowl_model``, which sets its own lateral grid: ``nyz`` then
    raises). ``out`` writes the result as ``.npz``."""
    if bowl and nyz is not None:
        raise ValueError("nyz is not supported with bowl=True: the bowl-fitted mesh sets its "
                         "own lateral grid")
    f0 = f0 or (F0_FULL if full else 0.5e6)
    before = snapshot()
    t0 = time.perf_counter()
    with tracing():
        if bowl:
            model, h, dt, spp = build_bowl_model(kind, tx, medium, nx, degree=degree, f0=f0,
                                                 dtype=dtype, device=device)
        else:
            model, h, dt, spp = build_model(kind, tx, medium, nx, degree=degree, f0=f0,
                                            dtype=dtype, nyz=nyz, device=device)
    _synchronize(model)
    setup = time.perf_counter() - t0
    split = split_setup(before, snapshot())
    c0 = MEDIA[medium]["c0"]
    tf = final_time or (TRANSDUCERS[tx]["L"] / c0 + 8.0 / f0)
    ndofs = model.number_of_dofs()
    name = f"{kind}-{tx}-{medium}" + ("-BOWLMESH" if bowl else "")
    print(f"HITU {name}: f0={f0/1e6:.2f} MHz  p={degree}  {c0 / f0 / h:.2f} elems/wavelength  "
          f"DOFs={ndofs/1e6:.2f}M  dt={dt:.3e}  steps={int(round(tf / dt))}  "
          f"steps/period={spp}  {model.step_kind} step on {model.device}")
    print("  setup split (host s, each phase's own): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    x, times, ys, elapsed = _record_axial(model, tx, tf)
    amp = steady_amplitude(times, ys, f0)
    i_pk = int(np.argmax(amp))
    print(f"  setup {setup:.1f} s, solve {elapsed:.2f} s ({ndofs * len(times) / elapsed / 1e9:.3f} "
          f"GDOF-steps/s) | peak |p| {amp[i_pk]/1e6:.3f} MPa at x={x[i_pk]*1e3:.2f} mm "
          f"(geometric focus {TRANSDUCERS[tx]['roc']*1e3:.1f} mm)")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        keep = times > times[-1] - 4.0 / f0
        sens = np.linspace(0, len(x) - 1, 31, dtype=int)
        np.savez_compressed(
            out, x=x, amplitude=amp, sensor_x=x[sens], times=times[keep],
            waveforms=ys[keep][:, sens],
            meta=json.dumps({"variant": name, "f0": f0, "nx": nx, "degree": degree, "dt": dt,
                             "ndofs": int(ndofs), "tf": tf,
                             "device": str(model.device)}),
        )
        print(f"  wrote {out}")
    return HituRun(x, amp, model, setup, elapsed, len(times), split)


def check_artifact(run, npz) -> dict:
    """Hold a run's steady axial amplitude (``run.x``, ``run.amplitude``:
    a ``HituRun`` or a ``ph1.Ph1Run``) against a committed run ``npz`` on
    the same sensors: the focal peak within 2% and its sensor within ±1 of
    the committed run's; the axial profile's largest difference, relative to
    the committed peak, is printed beside them. Returns the numbers and
    ``ok``."""
    ref = np.load(npz)
    ref_amp, ref_x = np.asarray(ref["amplitude"], np.float64), ref["x"]
    if np.shape(run.x) != ref_x.shape or not np.allclose(run.x, ref_x, rtol=0, atol=1e-12):
        raise ValueError(f"{npz}: the committed run's sensors are not this run's")
    amp = np.asarray(run.amplitude, np.float64)
    i_pk, i_ref = int(np.argmax(amp)), int(np.argmax(ref_amp))
    rel_peak = float((amp[i_pk] - ref_amp[i_ref]) / ref_amp[i_ref])
    profile = float(np.max(np.abs(amp - ref_amp)) / ref_amp[i_ref])
    ok = abs(rel_peak) < 0.02 and abs(i_pk - i_ref) <= 1
    print(f"  against {os.path.basename(npz)}: peak {amp[i_pk]:.6e} Pa at x = "
          f"{ref_x[i_pk]*1e3:.2f} mm (sensor {i_pk}), committed {ref_amp[i_ref]:.6e} Pa at "
          f"{ref_x[i_ref]*1e3:.2f} mm (sensor {i_ref}): relative difference {rel_peak:.4e}, "
          f"axial profile max rel diff {profile:.4e} -> {'PASS' if ok else 'MISS'} "
          f"(2%, ±1 sensor)", flush=True)
    return {"ok": ok, "rel_peak": rel_peak, "profile_rel": profile, "peak_pa": float(amp[i_pk]),
            "ref_pa": float(ref_amp[i_ref]), "sensor": i_pk, "ref_sensor": i_ref}


def _oneil_check(label, tx, f0, nx, degree, model, h, out):
    """Run ``model`` (linear, β = δ = 0) for the O'Neil check of transducer
    ``tx`` at ``f0`` and compare its steady axial amplitude with the O'Neil
    (1949) solution. Returns (focal-gain error, focal position error in m,
    focal-region L2 error)."""
    g = TRANSDUCERS[tx]
    c0 = MEDIA["WATER"]["c0"]
    p0 = MEDIA["WATER"]["rho0"] * c0 * SOURCE_VELOCITY[("W", tx, "WATER")]
    tf = g["L"] / c0 + 10.0 / f0
    ndofs = model.number_of_dofs()
    lam = c0 / f0
    print(f"{label} {tx}: f0={f0/1e6:.2f} MHz  p={degree}  "
          f"{lam/h:.2f} elems/wavelength  DOFs={ndofs/1e6:.2f}M  dt={model.dt:.3e}  "
          f"{model.step_kind} step on {model.device}")
    x, times, ys, elapsed = _record_axial(model, tx, tf)
    amp = steady_amplitude(times, ys, f0)
    k = 2 * np.pi * f0 / c0
    # the aperture plane is the bowl RIM plane: O'Neil's axial coordinate
    # (from the apex) is x + bowl depth
    h_depth = g["roc"] - np.sqrt(g["roc"] ** 2 - g["a"] ** 2)
    ref = oneil_axial_amplitude(x + h_depth, g["a"], g["roc"], k, p0)
    i_pk = int(np.argmax(amp))
    i_rf = int(np.argmax(ref))
    gain_err = abs(amp[i_pk] - ref[i_rf]) / ref[i_rf]
    pos_err = abs(x[i_pk] - x[i_rf])
    # profile error over the focal region (±1 focal-spot length)
    focal = np.abs(x - x[i_rf]) < 7 * lam
    prof_err = np.linalg.norm((amp - ref)[focal]) / np.linalg.norm(ref[focal])
    print(f"  solve {elapsed:.2f} s | focal |p|: model {amp[i_pk]/1e3:.1f} kPa "
          f"@ {x[i_pk]*1e3:.2f} mm, O'Neil {ref[i_rf]/1e3:.1f} kPa @ {x[i_rf]*1e3:.2f} mm")
    print(f"  focal-gain error {gain_err*100:.2f}%  position error "
          f"{pos_err*1e3:.2f} mm  focal-region L2 {prof_err*100:.2f}%")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        np.savez_compressed(
            out, x=x, amplitude=amp, oneil=ref,
            meta=json.dumps({"tx": tx, "f0": f0, "nx": nx, "degree": degree,
                             "gain_err": gain_err, "pos_err_mm": pos_err * 1e3,
                             "profile_err": prof_err, "ndofs": int(ndofs),
                             "device": str(model.device)}),
        )
        print(f"  wrote {out}")
    return gain_err, pos_err, prof_err


def validate_oneil(tx: str = "H101", f0: float = 0.35e6, nx: int = 64,
                   degree: int = 4, out: str | None = None, dtype=None, device="cuda"):
    """Linear (β = δ = 0) run of the phased-aperture bowl model against the
    O'Neil (1949) axial solution. Returns (focal-gain error, focal position
    error in m, focal-region L2 error)."""
    model, h, dt, spp = build_model("W", tx, "WATER", nx, degree=degree, f0=f0,
                                    dtype=dtype, linear=True, device=device)
    return _oneil_check("O'Neil validation", tx, f0, nx, degree, model, h, out)


def validate_bowl_mesh(tx: str = "H101", f0: float = 0.35e6, nx: int = 48,
                       degree: int = 4, out: str | None = None, dtype=None, device="cuda"):
    """Linear (β = δ = 0) run on the bowl-fitted mesh against the O'Neil
    (1949) axial solution: the curved-facet transducer checked end to end
    (the JAX package's ``benchmarks/hitu/common.py::validate_bowl_mesh``).
    Returns (focal-gain error, focal position error in m, focal-region L2
    error)."""
    model, h, dt, spp = build_bowl_model("W", tx, "WATER", nx, degree=degree, f0=f0,
                                         dtype=dtype, linear=True, device=device)
    return _oneil_check("O'Neil bowl-mesh validation", tx, f0, nx, degree, model, h, out)


def main(argv=None) -> None:
    """Command line: one HITU variant (or the O'Neil check) on a device."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kind", choices=["W", "V"])
    ap.add_argument("tx", choices=sorted(TRANSDUCERS))
    ap.add_argument("medium", choices=sorted(MEDIA))
    ap.add_argument("--nx", type=int, default=None, help="axial cells (default 80; O'Neil 64)")
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--full", action="store_true", help="true 1.1 MHz parameters")
    ap.add_argument("--f0", type=float, default=None)
    ap.add_argument("--nyz", type=int, default=None, help="lateral cell count")
    ap.add_argument("--out", type=str, default=None, help="write the result as .npz")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--oneil", action="store_true",
                    help="run the O'Neil check of transducer TX instead (WATER, linear)")
    ap.add_argument("--bowl", action="store_true",
                    help="on the bowl-fitted mesh (curved transducer facets) instead of the "
                         "phased flat aperture")
    ap.add_argument("--check", default=None,
                    help="a committed run (.npz) to hold the result against: the focal peak "
                         "(check_artifact), or with --oneil its O'Neil errors, printed beside")
    args = ap.parse_args(argv)
    if args.oneil:
        check = validate_bowl_mesh if args.bowl else validate_oneil
        errs = check(args.tx, f0=args.f0 or 0.35e6, nx=args.nx or 64, degree=args.degree,
                     out=args.out, device=args.device)
        if args.check:
            ref = json.loads(str(np.load(args.check)["meta"]))
            print(f"  committed run {os.path.basename(args.check)}: gain error "
                  f"{ref['gain_err']*100:.3f}% (here {errs[0]*100:.3f}%), position error "
                  f"{ref['pos_err_mm']:.3f} mm (here {errs[1]*1e3:.3f}), focal L2 "
                  f"{ref['profile_err']*100:.3f}% (here {errs[2]*100:.3f}%)")
        return
    res = run(args.kind, args.tx, args.medium, nx=args.nx or 80, degree=args.degree,
              full=args.full, f0=args.f0, out=args.out, nyz=args.nyz, bowl=args.bowl,
              device=args.device)
    if args.check and not check_artifact(res, args.check)["ok"]:
        raise SystemExit(f"focal peak outside 2% / ±1 sensor of {args.check}")


if __name__ == "__main__":
    main()
