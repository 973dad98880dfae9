"""PH1 transcranial-ultrasound benchmark suite (Aubry et al. 2022), the port
of the JAX package's ``benchmarks/ph1/common.py``, ``run_all.py``, the 14
``sc*_bm*.py`` scripts and the numpy checks of ``validate.py``.

The reference's 14 PH1 drivers
(``cpp/fenicsx-sf-naive/benchmarks/PH1/SC{1,2}-BM{1..7}/main.cpp``):
intercomparison scenarios SC1 (planar 20 mm piston) and SC2 (focused bowl,
64 mm aperture, 64 mm radius of curvature) through benchmarks BM1-BM7
(water → lossy water → flat/curved/layered skull → CT-skull stand-in).
Material constants are the reference drivers' (skin/bone properties
``SC1-BM4/main.cpp:41-60``). The media layers of the published benchmark
spec are voxelised onto the structured lattice as DG-0 cell coefficients
(cell-centroid classification). Sources are driven through facet tags (SC1)
or a phased flat aperture equivalent to the bowl (SC2), or with
``bowl=True`` the bowl-fitted mesh (``core/bowl.py``).

Run on the card: ``python -m fenicsxfus_tpu_torch.drivers.ph1 --sc 1 --bm 4
[--nx 80] [--out run.npz]`` for one case, ``--all [--out DIR]`` for the 14
cases in order (a case that fails raises and ends the sweep), ``--check DIR``
to hold each case's focal peak against ``DIR/sc{N}_bm{M}.npz``
(``hitu.check_artifact``; with ``--snap``, at the committed runs' sampling,
each sensor at its nearest node), ``--dtype float64`` for an fp64 run.

The validation stamp of the JAX package's ``validate.py``: ``python -m
fenicsxfus_tpu_torch.drivers.ph1 --validate --sc 1 --bm 4 [--nx 80]
[--nx-fine 112] [--out stamp.json] [--published table.json]`` runs
``validate``: nx-refinement convergence, tf stationarity, the water cases'
focal metrics against the closed forms, the flat-layer 1D transmission
check and, where a transcription of the Aubry et al. tables is given
(``--published``; none is in the repository, and the default path beside
this file does not exist), the deltas against it. The stamp is written only
to ``--out``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..analysis.timing import span, traced
from ..core.bowl import create_bowl_box
from ..core.mesh import create_box, tag_boundaries
from ..models.focused import WesterveltSpectralFocused
from ..models.linear import LinearSpectralExplicit
from ..models.lossy import LossySpectralExplicit
from ..models.westervelt import WesterveltSpectralExplicit
from ..utils import (compute_diffusivity_of_sound, estimate_stable_dt, init_device,
                     resolve_device)
from .hitu import _synchronize, check_artifact

# --------------------------------------------------------------------------
# constants from the reference drivers
F0 = 0.5e6  # source frequency (Hz)
P0 = 60000.0  # source amplitude (Pa)
W0 = 2.0 * np.pi * F0
DOMAIN_L = 0.12  # axial length (m)  (main.cpp:45)
DOMAIN_W = 0.07  # transverse width (m) (benchmark spec)
SC1_RADIUS = 0.01  # planar source radius (m)
SC2_APERTURE = 0.032  # bowl half-aperture (m)
SC2_ROC = 0.064  # bowl radius of curvature (m)

# (c0 m/s, rho0 kg/m^3, attenuation dB/m) — reference SC*-BM*/main.cpp
MATERIALS = {
    "water": (1500.0, 1000.0, 0.0),
    "water_att": (1500.0, 1000.0, 100.0),  # SC1-BM2/main.cpp:38-41
    "skin": (1610.0, 1090.0, 20.0),  # SC1-BM4/main.cpp:41-47
    "cortical": (2800.0, 1850.0, 400.0),  # SC1-BM4/main.cpp:49-55
    "trabecular": (2300.0, 1700.0, 800.0),  # SC1-BM4/main.cpp:57-60
    # BM7 runs water-valued properties with 100 dB/m at p=5 in the
    # reference (SC1-BM7/main.cpp:36-44 — bone values commented out)
    "bm7": (1500.0, 1000.0, 100.0),
}

# Layer geometry (published benchmark spec; meshes not in the reference
# repo). Flat layers: (material, x_lo, x_hi). Curved layers: concentric
# spherical shells, centre on the axis at apex + ROC, ROC = 75 mm.
CURVE_ROC = 0.075
BM_LAYERS = {
    1: [],
    2: [],
    3: [("cortical", 0.030, 0.0365)],
    4: [
        ("skin", 0.026, 0.030),
        ("cortical", 0.030, 0.0315),
        ("trabecular", 0.0315, 0.0355),
        ("cortical", 0.0355, 0.037),
    ],
    5: [("cortical", 0.030, 0.0365)],
    6: [
        ("skin", 0.026, 0.030),
        ("cortical", 0.030, 0.0315),
        ("trabecular", 0.0315, 0.0355),
        ("cortical", 0.0355, 0.037),
    ],
    7: [("bm7", 0.030, 0.0365)],
}
BM_CURVED = {1: False, 2: False, 3: False, 4: False, 5: True, 6: True, 7: True}
BM_BACKGROUND = {1: "water", 2: "water_att", 3: "water", 4: "water",
                 5: "water", 6: "water", 7: "water"}
BM_DEGREE = {1: 4, 2: 4, 3: 4, 4: 4, 5: 4, 6: 4, 7: 5}
CASES = [(sc, bm) for sc in (1, 2) for bm in range(1, 8)]


def build_media(mesh, bm: int):
    """Per-cell (c0, rho0, delta0) DG-0 fields for benchmark ``bm``."""
    cents = mesh.cell_midpoints()  # [Nc, 3]
    nc = cents.shape[0]

    def mat_fields(name):
        c, rho, att = MATERIALS[name]
        return c, rho, compute_diffusivity_of_sound(W0, c, att)

    c0 = np.empty(nc)
    rho0 = np.empty(nc)
    delta0 = np.empty(nc)
    cb, rb, db = mat_fields(BM_BACKGROUND[bm])
    c0[:] = cb
    rho0[:] = rb
    delta0[:] = db

    layers = BM_LAYERS[bm]
    if not layers:
        return c0, rho0, delta0
    if not BM_CURVED[bm]:
        for name, xlo, xhi in layers:
            mask = (cents[:, 0] >= xlo) & (cents[:, 0] < xhi)
            c0[mask], rho0[mask], delta0[mask] = mat_fields(name)
    else:
        # concentric shells: outermost apex at layers[0][1], centre at
        # apex + ROC on the axis; shell for (xlo, xhi) has radii
        # [ROC - (xhi - apex), ROC - (xlo - apex)]
        apex = layers[0][1]
        centre = np.array([apex + CURVE_ROC, 0.0, 0.0])
        r = np.linalg.norm(cents - centre[None, :], axis=1)
        for name, xlo, xhi in layers:
            r_out = CURVE_ROC - (xlo - apex)
            r_in = CURVE_ROC - (xhi - apex)
            mask = (r > r_in) & (r <= r_out) & (cents[:, 0] < centre[0])
            c0[mask], rho0[mask], delta0[mask] = mat_fields(name)
    return c0, rho0, delta0


def _lateral_cells(nx: int) -> tuple[float, int]:
    """(h, nyz): the transverse cell count keeps cells near-cubic."""
    h = DOMAIN_L / nx
    return h, max(int(round(DOMAIN_W / h)), 2)


def build_mesh(nx: int, degree: int):
    """Structured box [0, L] x [-W/2, W/2]^2 with the transverse cell count
    scaled to keep cells near-cubic."""
    h, nyz = _lateral_cells(nx)
    mesh = create_box((nx, nyz, nyz), (0.0, -DOMAIN_W / 2, -DOMAIN_W / 2),
                      (DOMAIN_L, DOMAIN_W / 2, DOMAIN_W / 2))
    return mesh, h


def tag_scenario(mesh, sc: int):
    """Facet tags: tag 1 = source aperture on the x=0 plane (disc of the
    scenario's radius), tag 2 = Sommerfeld ABC on the five outer faces;
    the rest of the x=0 plane is a rigid baffle (natural Neumann: untagged,
    so ``tag_boundaries`` gets no default)."""
    a = SC1_RADIUS if sc == 1 else SC2_APERTURE
    W = DOMAIN_W / 2
    eps = 1e-9

    def src(x):
        return (x[0] < eps) & (np.hypot(x[1], x[2]) <= a)

    def abc(x):
        return (x[0] > DOMAIN_L - eps) | (np.abs(x[1]) > W - eps) | (np.abs(x[2]) > W - eps)

    tag_boundaries(mesh, {1: src, 2: abc})
    return mesh


@traced("fus.setup", sync=True)
def build_model(sc: int, bm: int, nx: int, dtype=None, cfl=0.5, bowl: bool = False,
                device="cuda"):
    """Assemble the model for scenario ``sc``, benchmark ``bm``: SC1 the
    linear (BM1) or lossy model with the facet source, SC2 the focused
    model's phased flat aperture (β = 0), or with ``bowl=True`` (SC2 only)
    the Westervelt model (β = 0) on the bowl-fitted mesh, whose blend depth
    (about 26 mm) ends before the first skull layer, its dt clamped by the
    measured spectrum. Returns (model, mesh, h, dt, steps per period)."""
    dtype = dtype or torch.float32
    degree = BM_DEGREE[bm]
    if bowl and sc != 2:
        raise ValueError("bowl meshes apply to the SC2 (focused) scenario")
    with span("fus.setup.mesh"):
        if bowl:
            _, nyz = _lateral_cells(nx)
            mesh, _focus = create_bowl_box((nx, nyz, nyz), (0.0, -DOMAIN_W / 2, -DOMAIN_W / 2),
                                           (DOMAIN_L, DOMAIN_W / 2, DOMAIN_W / 2), SC2_ROC,
                                           SC2_APERTURE)
            h_cfl = mesh.h_min()
        else:
            mesh, h_cfl = build_mesh(nx, degree)
            tag_scenario(mesh, sc)
    with span("fus.setup.assembly"):
        c0, rho0, delta0 = build_media(mesh, bm)

    cmax = float(np.max(c0))
    period = 1.0 / F0
    dt = cfl * h_cfl / (cmax * degree**2)
    steps_per_period = int(period / dt) + 1
    dt = period / steps_per_period

    kw = dict(dtype=dtype, device=device)
    init_device(device)
    with span("fus.setup.assembly"):
        if sc == 1 and bm == 1:
            model = LinearSpectralExplicit(mesh, None, degree, c0, rho0, F0, P0, 1500.0, 4, dt,
                                           **kw)
        elif sc == 1:
            model = LossySpectralExplicit(mesh, None, degree, c0, rho0, delta0, F0, P0, 1500.0,
                                          4, dt, **kw)
        elif bowl:
            # curved transducer facets: plain uniform source, focusing from the
            # geometry (β = 0: PH1 is linear/lossy)
            model = WesterveltSpectralExplicit(mesh, None, degree, c0, rho0, delta0, 0.0, F0,
                                               P0, 1500.0, 4, dt, **kw)
        else:
            # the focused bowl as a phased flat aperture (O'Neil-validated)
            model = WesterveltSpectralFocused(mesh, None, degree, c0, rho0, delta0, 0.0, F0,
                                              P0, 1500.0, 4, dt, aperture_radius=SC2_APERTURE,
                                              focal_distance=SC2_ROC,
                                              center=np.array([0.0, 0.0, 0.0]), **kw)
        model.init()
    if bowl:
        # skewed blend-band cells: clamp dt with the measured spectrum
        dt_star = estimate_stable_dt(model.ops, c0, rho0, rk_order=4)
        if dt_star < dt:
            steps_per_period = int(period / dt_star) + 1
            dt = period / steps_per_period
            model.dt = dt
    return model, mesh, h_cfl, dt, steps_per_period


def axial_points(n=121):
    x = np.linspace(0.0, DOMAIN_L, n)
    return np.stack([x, np.zeros_like(x), np.zeros_like(x)])


def steady_amplitude(times, ys, n_periods=2):
    """Per-sensor steady-state amplitude: max |p| over the trailing
    ``n_periods`` source periods of the recorded series (host arrays)."""
    tail = times > times[-1] - n_periods / F0
    return np.max(np.abs(ys[tail]), axis=0)


def default_final_time() -> float:
    """The end time of a PH1 run: the domain's transit plus 8 periods."""
    return DOMAIN_L / 1500.0 + 8.0 / F0


@dataclass
class Ph1Run:
    """One PH1 run: axial positions, steady amplitude, and what it cost."""

    x: np.ndarray
    amplitude: np.ndarray
    model: object
    setup_s: float  # mesh, media, host assembly and upload
    solve_s: float  # the time march with in-loop recording (host clock)
    nsteps: int
    times: np.ndarray  # the recorded step times
    ys: np.ndarray  # [nsteps, 121] the recorded axial pressure (host)


def record(model, tf: float, snap: bool = False):
    """``rk_record`` of the 121 axial sensors from t = 0 to ``tf`` (with
    ``snap``, at the DOF nodes nearest them): (x of the axial sensors,
    times, ys on the host, solve seconds)."""
    pts = axial_points()
    if snap:
        pts = model.ops.dof_coords()[model.sensor_indices(pts)].T
    _synchronize(model)
    t0 = time.perf_counter()
    _, _, _, times, ys = model.rk_record(0.0, tf, pts)
    ys = ys.cpu().numpy()  # waits for the device
    return axial_points()[0], times, ys, time.perf_counter() - t0


def run(sc: int, bm: int, nx: int = 80, out: str | None = None,
        final_time: float | None = None, dtype=None, bowl: bool = False,
        device="cuda", snap: bool = False) -> Ph1Run:
    """Run one PH1 scenario/benchmark and read the steady amplitude at 121
    axial sensors, interpolated off the nodes as the JAX package does;
    ``snap=True`` reads each sensor at its nearest DOF node instead, the
    sampling of the JAX package's committed runs under ``benchmarks/ph1/
    results/`` (recorded before it interpolated off-node sensors; at
    nx = 80 the 1 mm sensor spacing puts most sensors between nodes).
    ``bowl=True``: the bowl-fitted mesh (SC2 only). ``out`` writes the JAX
    package's reduced artifact (axial amplitude and the last 3 periods at 9
    stations) as ``.npz``."""
    t0 = time.perf_counter()
    model, mesh, h, dt, spp = build_model(sc, bm, nx, dtype=dtype, bowl=bowl, device=device)
    _synchronize(model)
    setup = time.perf_counter() - t0
    ndofs = model.number_of_dofs()
    tf = final_time or default_final_time()
    nsteps = int(round(tf / dt))
    print(f"PH1 SC{sc}-BM{bm}{' BOWLMESH' if bowl else ''}: p={BM_DEGREE[bm]}  "
          f"h={h*1e3:.2f} mm  DOFs={ndofs/1e6:.2f}M  dt={dt:.3e}  steps={nsteps}  "
          f"steps/period={spp}  {model.step_kind} step on {model.device}", flush=True)
    x, times, ys, elapsed = record(model, tf, snap)
    amp = steady_amplitude(times, ys)
    i_pk = int(np.argmax(amp))
    print(f"  setup {setup:.1f} s, solve {elapsed:.2f} s "
          f"({ndofs * len(times) / elapsed / 1e9:.3f} GDOF-steps/s) | peak "
          f"{amp[i_pk]/1e3:.1f} kPa at x={x[i_pk]*1e3:.1f} mm", flush=True)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        keep = times > times[-1] - 3.0 / F0
        sens = np.linspace(0, len(x) - 1, 9, dtype=int)
        np.savez_compressed(
            out, x=x, amplitude=amp, sensor_x=x[sens], times=times[keep],
            waveforms=ys[keep][:, sens],
            meta=json.dumps({"sc": sc, "bm": bm, "nx": nx, "dt": dt, "ndofs": int(ndofs),
                             "tf": tf, "mesh": "bowl-fitted" if bowl else "flat-phased",
                             "sensors": "nearest node" if snap else "interpolated",
                             "device": str(model.device)}),
        )
        print(f"  wrote {out}")
    return Ph1Run(x, amp, model, setup, elapsed, len(times), times, ys)


# --------------------------------------------------------------------------
# validation (the numpy checks of the JAX package's ``validate.py``)


def run_profile(sc, bm, nx, tf=None, dtype=None, device="cuda", profiles=None):
    """(x, steady amplitude) of one run ending at ``tf``; ``profiles``, a
    dict, keeps each (sc, bm, nx, tf, dtype) profile so a validation that
    asks for it again runs it once."""
    tf = tf or default_final_time()
    key = (sc, bm, nx, round(tf * 1e9), dtype)
    if profiles is not None and key in profiles:
        return profiles[key]
    model, *_ = build_model(sc, bm, nx, dtype=dtype, device=device)
    x, times, ys, elapsed = record(model, tf)
    print(f"  SC{sc}-BM{bm} nx={nx} tf={tf*1e6:.1f}us: {model.number_of_dofs()/1e6:.2f}M DOFs, "
          f"{elapsed:.1f}s")
    result = (x, steady_amplitude(times, ys))
    if profiles is not None:
        profiles[key] = result
    return result


def convergence(sc, bm, nx, nx_fine, dtype=None, tf=None, device="cuda", profiles=None):
    """Relative L2 distance between the axial amplitude profiles at two
    resolutions (excluding the near-source singularity x < 5 mm)."""
    x, amp_c = run_profile(sc, bm, nx, tf=tf, dtype=dtype, device=device, profiles=profiles)
    _, amp_f = run_profile(sc, bm, nx_fine, tf=tf, dtype=dtype, device=device,
                           profiles=profiles)
    sel = x > 0.005
    rel = np.linalg.norm((amp_c - amp_f)[sel]) / np.linalg.norm(amp_f[sel])
    pk_c, pk_f = float(np.max(amp_c)), float(np.max(amp_f))
    print(f"  convergence SC{sc}-BM{bm} nx {nx}->{nx_fine}: profile L2 {rel*100:.2f}%  peak "
          f"{pk_c/1e3:.1f} -> {pk_f/1e3:.1f} kPa ({abs(pk_c-pk_f)/pk_f*100:.2f}%)")
    return {"nx": nx, "nx_fine": nx_fine, "profile_l2": float(rel),
            "peak_rel": float(abs(pk_c - pk_f) / pk_f)}


def tf_stationarity(sc, bm, nx, extra_periods=4, dtype=None, device="cuda", profiles=None):
    """Amplitude change when the run is extended by ``extra_periods``."""
    base_tf = default_final_time()
    x, amp_a = run_profile(sc, bm, nx, tf=base_tf, dtype=dtype, device=device,
                           profiles=profiles)
    _, amp_b = run_profile(sc, bm, nx, tf=base_tf + extra_periods / F0, dtype=dtype,
                           device=device, profiles=profiles)
    sel = x > 0.005
    rel = np.linalg.norm((amp_a - amp_b)[sel]) / np.linalg.norm(amp_b[sel])
    print(f"  tf-stationarity SC{sc}-BM{bm} nx={nx} (+{extra_periods}T): profile L2 "
          f"{rel*100:.2f}%")
    return {"nx": nx, "extra_periods": extra_periods, "profile_l2": float(rel)}


def transmission_stack(stack, w0=W0, Z_outer=None):
    """|T| for a plane wave at normal incidence through ``stack`` =
    [(c, rho, alpha_Np_per_m, thickness), ...] between identical outer
    half-spaces of impedance ``Z_outer`` (default: PH1 water) — the
    impedance-transfer matrix result. Pressure amplitude ratio
    transmitted / incident."""
    if Z_outer is None:
        c_w, rho_w, _ = MATERIALS["water"]
        Z_outer = rho_w * c_w
    Zw = Z_outer
    M = np.eye(2, dtype=complex)
    for c, rho, alpha, L in stack:
        k = w0 / c - 1j * alpha
        Z = rho * c
        cos, sin = np.cos(k * L), np.sin(k * L)
        M = M @ np.array([[cos, 1j * Z * sin], [1j * sin / Z, cos]])
    denom = M[0, 0] * Zw + M[0, 1] + Zw * (M[1, 0] * Zw + M[1, 1])
    return float(abs(2.0 * Zw / denom))


def transmission_1d(bm):
    """Plane-wave normal-incidence amplitude transmission through the flat
    layer stack of benchmark ``bm``, water -> water."""
    layers = BM_LAYERS[bm]
    if not layers:
        return 1.0
    stack = []
    for name, xlo, xhi in layers:
        c, rho, att_dB = MATERIALS[name]
        stack.append((c, rho, att_dB / 20.0 * np.log(10.0), xhi - xlo))
    return transmission_stack(stack)


def transmission_check(sc, bm, x, amp, x_ref, amp_ref, tol=0.35):
    """Compare the measured transmission through the (flat) layer stack
    with the 1D impedance-transfer prediction. ``measured`` is the ratio
    of the benchmark profile to the WATER (BM1) profile averaged over a
    window behind the stack — dividing by the free-field profile removes
    both the piston's axial structure and the standing-wave contamination
    in front of the stack. Loose gate: refraction, lateral spreading and
    reverberation are outside the 1D model. None for benchmarks with no
    flat layers."""
    layers = BM_LAYERS[bm]
    if not layers or BM_CURVED[bm]:
        return None
    x_out0 = layers[-1][2] + 0.005
    win = (x >= x_out0) & (x <= x_out0 + 0.020)
    ref = np.interp(x[win], x_ref, amp_ref)
    measured = float(np.mean(amp[win] / ref))
    predicted = transmission_1d(bm)
    rel = abs(measured - predicted) / predicted
    print(f"  1D transmission SC{sc}-BM{bm}: measured {measured:.3f}  predicted "
          f"{predicted:.3f}  rel {rel*100:.1f}%")
    return {"measured": measured, "predicted": predicted, "rel": float(rel), "tol": tol,
            "pass": bool(rel < tol)}


def _complex_axial_amplitude(z, sc, alpha_np):
    """On-axis steady amplitude of the SC1 piston / SC2 bowl in a medium
    with attenuation ``alpha_np`` (Np/m), from the exact two-ray form of
    the Rayleigh/O'Neil solutions with complex wavenumber:

        SC1:  |p| = p0 |e^{i k̃ z} - e^{i k̃ R}|,  R = sqrt(z^2 + a^2)
        SC2:  |p| = p0 |e^{i k̃ z} - e^{i k̃ r_e}| / |1 - z/roc|

    At alpha=0 these reduce to ``piston_axial_amplitude`` /
    ``oneil_axial_amplitude``. ``z`` is the domain coordinate (source plane
    at z=0); for SC2 the O'Neil apex coordinate is z + h (h = bowl depth)."""
    z = np.asarray(z, np.float64)
    cw = MATERIALS["water"][0]
    kt = W0 / cw + 1j * alpha_np
    if sc == 1:
        a = SC1_RADIUS
        R = np.sqrt(z * z + a * a)
        return P0 * np.abs(np.exp(1j * kt * z) - np.exp(1j * kt * R))
    a, roc = SC2_APERTURE, SC2_ROC
    h = roc - np.sqrt(roc * roc - a * a)
    zo = z + h  # O'Neil apex coordinate
    # the removable singularity at the geometric focus: evaluate at
    # roc - eps like ``oneil_axial_amplitude``
    eps = 1e-6 * roc
    zo = np.where(np.abs(1.0 - zo / roc) < 1e-7, roc - eps, zo)
    r_e = np.sqrt((zo - h) ** 2 + a * a)
    denom = np.abs(1.0 - zo / roc)
    return P0 * np.abs(np.exp(1j * kt * zo) - np.exp(1j * kt * r_e)) / denom


def focal_metrics(x, amp, lo=0.005):
    """(focal pressure Pa, focal position m, -6 dB axial extent m) from an
    axial amplitude profile. Peak position refined with a 3-point parabola;
    -6 dB crossings linearly interpolated around the peak."""
    x = np.asarray(x, np.float64)
    amp = np.asarray(amp, np.float64)
    sel = x >= lo
    xs, As = x[sel], amp[sel]
    i = int(np.argmax(As))
    pk, xpk = float(As[i]), float(xs[i])
    if 0 < i < len(xs) - 1:
        y0, y1, y2 = As[i - 1], As[i], As[i + 1]
        d = y0 - 2 * y1 + y2
        if d < 0:
            off = 0.5 * (y0 - y2) / d
            xpk = float(xs[i] + off * (xs[min(i + 1, len(xs) - 1)] - xs[i]))
            pk = float(y1 - 0.25 * (y0 - y2) * off)
    half = 0.5 * pk  # -6 dB in pressure amplitude
    jlo = i
    while jlo > 0 and As[jlo] > half:
        jlo -= 1
    jhi = i
    while jhi < len(As) - 1 and As[jhi] > half:
        jhi += 1

    def _cross(j0, j1):
        a0, a1 = As[j0], As[j1]
        if a1 == a0:
            return xs[j0]
        t = (half - a0) / (a1 - a0)
        return xs[j0] + t * (xs[j1] - xs[j0])

    x_lo = _cross(jlo, jlo + 1) if As[jlo] <= half else float(xs[0])
    x_hi = _cross(jhi - 1, jhi) if As[jhi] <= half else float(xs[-1])
    return pk, xpk, float(x_hi - x_lo)


def focal_reference(sc, bm):
    """Closed-form focal metrics for the water benchmarks (BM1 exact, BM2
    exact two-ray with attenuation); None for the skull cases, which the 1D
    transmission model gates instead."""
    if bm not in (1, 2):
        return None
    att_dB = MATERIALS[BM_BACKGROUND[bm]][2]
    alpha = att_dB / 20.0 * np.log(10.0)
    z = np.linspace(0.0, DOMAIN_L, 48001)
    amp = _complex_axial_amplitude(z, sc, alpha)
    pk, xpk, ext = focal_metrics(z, amp)
    return {"focal_p": pk, "focal_x": xpk, "ext6": ext}


# Where a transcription of the Aubry et al. (2022) tables would sit: no such
# file is committed (nothing could check it against the paper), so by
# default the loader finds none and the closed forms gate the water cases.
PUBLISHED_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "ph1_published_values.json")
PUBLISHED_FIELDS = {"source", "code", "focal_p_Pa", "focal_x_m", "ext6_m"}


def published_values(sc, bm, path=None):
    """The focal metrics of the Aubry et al. (2022) intercomparison (J.
    Acoust. Soc. Am. 152, 1003) for SC``sc``-BM``bm`` from the JSON file
    ``path`` (default ``PUBLISHED_FILE``), or None when the file or the case
    is absent. The JAX package's schema; every field is required, so the
    provenance is never lost::

        {"SC1-BM1": {"source": "doi:10.1121/10.0013426, Table III",
                     "code": "KWAVE", "focal_p_Pa": ..., "focal_x_m": ...,
                     "ext6_m": ...}, ...}
    """
    path = PUBLISHED_FILE if path is None else path
    if not os.path.exists(path):
        return None
    with open(path) as f:
        table = json.load(f)
    ent = table.get(f"SC{sc}-BM{bm}")
    if ent is None:
        return None
    missing = PUBLISHED_FIELDS - set(ent)
    if missing:
        raise ValueError(f"{os.path.basename(path)} SC{sc}-BM{bm}: missing fields {missing} "
                         "(provenance is required; see published_values)")
    return ent


def published_comparison(sc, bm, x, amp, path=None):
    """Deltas of the profile's focal metrics against a transcribed
    intercomparison entry (``published_values``), or None without one."""
    ent = published_values(sc, bm, path)
    if ent is None:
        return None
    pk, xpk, ext = focal_metrics(x, amp)
    out = {
        "published": ent,
        "measured": {"focal_p": pk, "focal_x": xpk, "ext6": ext},
        "dp_rel": float(abs(pk - ent["focal_p_Pa"]) / ent["focal_p_Pa"]),
        "dx_mm": float(abs(xpk - ent["focal_x_m"]) * 1e3),
        "dext_rel": float(abs(ext - ent["ext6_m"]) / ent["ext6_m"]),
    }
    print(f"  vs published ({ent['code']}, {ent['source']}): dP {out['dp_rel']*100:.2f}%  "
          f"dx {out['dx_mm']:.2f} mm  dext {out['dext_rel']*100:.1f}%")
    return out


def focal_comparison(sc, bm, x, amp):
    """The profile's focal metrics against the closed form's for a water
    benchmark (``focal_reference``); None for the skull cases."""
    ref = focal_reference(sc, bm)
    if ref is None:
        return None
    pk, xpk, ext = focal_metrics(x, amp)
    out = {
        "measured": {"focal_p": pk, "focal_x": xpk, "ext6": ext},
        "reference": ref,
        "dp_rel": float(abs(pk - ref["focal_p"]) / ref["focal_p"]),
        "dx_mm": float(abs(xpk - ref["focal_x"]) * 1e3),
        "dext_rel": float(abs(ext - ref["ext6"]) / ref["ext6"]),
    }
    print(f"  focal SC{sc}-BM{bm}: P {pk/1e3:.1f} kPa (ref {ref['focal_p']/1e3:.1f}, "
          f"{out['dp_rel']*100:.2f}%)  x {xpk*1e3:.2f} mm (ref {ref['focal_x']*1e3:.2f}, "
          f"d {out['dx_mm']:.2f} mm)  -6dB ext {ext*1e3:.1f} mm (ref {ref['ext6']*1e3:.1f}, "
          f"{out['dext_rel']*100:.1f}%)")
    return out


def platform(device) -> str:
    """The stamp's platform: the torch device type, and the card's name on
    the card."""
    dev = torch.device(device)
    return f"cuda ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else dev.type


def validate(sc, bm, nx, nx_fine, dtype=None, out=None, device="cuda", published=None,
             profiles=None) -> dict:
    """The validation stamp of one case: convergence (nx → nx_fine),
    tf stationarity, the focal comparison (water cases), the published
    deltas (where ``published``, a table file, holds the case) and the
    flat-layer 1D transmission check (against the BM1 profile). Each
    profile runs once (``profiles``). The stamp is written as JSON to
    ``out`` if given, and nowhere else."""
    profiles = {} if profiles is None else profiles
    stamp = {"sc": sc, "bm": bm, "platform": platform(resolve_device(device))}
    kw = dict(dtype=dtype, device=device, profiles=profiles)
    stamp["convergence"] = convergence(sc, bm, nx, nx_fine, **kw)
    stamp["tf_stationarity"] = tf_stationarity(sc, bm, nx, **kw)
    x, amp = run_profile(sc, bm, nx, **kw)
    fc = focal_comparison(sc, bm, x, amp)
    if fc is not None:
        stamp["focal"] = fc
    pc = published_comparison(sc, bm, x, amp, published)
    if pc is not None:
        stamp["published"] = pc
    if BM_LAYERS[bm] and not BM_CURVED[bm]:
        xw, ampw = run_profile(sc, 1, nx, **kw)
        stamp["transmission_1d"] = transmission_check(sc, bm, x, amp, xw, ampw)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(stamp, f, indent=1)
        print(f"  wrote {out}")
    return stamp


# --------------------------------------------------------------------------
# command line


def main(argv=None) -> None:
    """Command line: one PH1 case, all 14 in order (``--all``), or one
    case's validation stamp (``--validate``)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sc", type=int, choices=(1, 2))
    ap.add_argument("--bm", type=int, choices=range(1, 8))
    ap.add_argument("--all", action="store_true", help="the 14 cases SC1-BM1 .. SC2-BM7")
    ap.add_argument("--nx", type=int, default=80)
    ap.add_argument("--bowl", action="store_true", help="the bowl-fitted mesh (SC2 only)")
    ap.add_argument("--out", default=None,
                    help="write the result as .npz (with --all: a directory of sc*_bm*.npz)")
    ap.add_argument("--check", default=None,
                    help="a directory of committed sc*_bm*.npz to hold each focal peak against")
    ap.add_argument("--snap", action="store_true",
                    help="read each sensor at its nearest node (the committed runs' sampling)")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--validate", action="store_true",
                    help="the case's validation stamp (with --out: its JSON file)")
    ap.add_argument("--nx-fine", type=int, default=112, help="--validate's finer nx")
    ap.add_argument("--published", default=None,
                    help="--validate: a JSON transcription of the published tables")
    args = ap.parse_args(argv)
    if args.validate:
        if args.sc is None or args.bm is None or args.all:
            ap.error("--validate takes one case: --sc and --bm")
        validate(args.sc, args.bm, args.nx, args.nx_fine, dtype=getattr(torch, args.dtype),
                 out=args.out, device=args.device, published=args.published)
        return
    if args.all == (args.sc is not None or args.bm is not None):
        ap.error("give --sc and --bm, or --all")
    if not args.all and (args.sc is None or args.bm is None):
        ap.error("give both --sc and --bm")
    if args.all and args.bowl:
        ap.error("--bowl applies to SC2 only, not to --all")
    cases = CASES if args.all else [(args.sc, args.bm)]
    missed = []
    for sc, bm in cases:
        name = f"sc{sc}_bm{bm}.npz"
        out = os.path.join(args.out, name) if (args.all and args.out) else args.out
        res = run(sc, bm, nx=args.nx, out=out, bowl=args.bowl, device=args.device,
                  dtype=getattr(torch, args.dtype), snap=args.snap)
        if args.check:
            if not check_artifact(res, os.path.join(args.check, name))["ok"]:
                missed.append(f"SC{sc}-BM{bm}")
    if missed:
        raise SystemExit(f"focal peak outside 2% / ±1 sensor of the committed run: {missed}")


if __name__ == "__main__":
    main()
