"""Long-run fp32 drift against fp64: the port's counterpart of the JAX
package's ``benchmarks/fp32_drift.py``.

Production runs march 7488+ RK4 steps in fp32 (the 1.1 MHz W-H131-WATER
run). This tool marches a reduced CW problem — the same physics family,
windowed source + ABC, steady periodic state — in fp32 and fp64 side by side
on one device and records the relative L2 divergence at checkpoints out past
the production step count, plus each run's error against the analytical
plane wave (linear only), so discretization error and dtype drift are
visible separately. The problem is the JAX tool's: the 2D channel 41 x 6,
p = 4, source at x = 0, ABC at x = 1, dt = 0.9·h/(c0·16), exactly a 1D plane
wave. (In 2D the models take the unfused step over the plain ``apply_scaled``,
as the JAX package has no kernel there.)

    python3 -m fenicsxfus_tpu_torch.tools.fp32_drift [--steps 8000]
        [--model linear|westervelt] [--device cuda] [--out table.txt]

The table has the JAX tool's format (``benchmarks/fp32_drift*.txt``); its
gates are ``tests/test_fp32_drift.py``'s: drift_l2 < 1e-4 from 7488 steps
on, and (linear) the fp32 analytic error below twice the fp64 one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

F0, P0, C0, RHO0 = 10.0, 4.0, 1.0, 4.0
NX = 41


def build(model_kind: str, dtype, device="cuda"):
    """The drift problem's model in ``dtype`` on ``device``: (model, dt)."""
    import fenicsxfus_tpu_torch as ft

    mesh = ft.create_rectangle((NX, 6), (0, 0), (1.0, 0.15))
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
    dt = 0.9 * (1.0 / NX) / (C0 * 16)
    if model_kind == "westervelt":
        # modest nonlinearity + attenuation: shock distance
        # rho0 c0^3/(beta w0 p0) ~ 3.2 domain lengths
        delta0, beta0 = 2e-4, 0.005
        m = ft.WesterveltSpectralExplicit(mesh, None, 4, C0, RHO0, delta0, beta0, F0, P0, C0, 4,
                                          dt, dtype=dtype, device=device)
    elif model_kind == "linear":
        m = ft.LinearSpectralExplicit(mesh, None, 4, C0, RHO0, F0, P0, C0, 4, dt, dtype=dtype,
                                      device=device)
    else:
        raise ValueError(f"model {model_kind!r}: linear or westervelt")
    m.init()
    return m, dt


def checkpoints(steps: int) -> list[int]:
    return sorted({c for c in (250, 500, 1000, 2000, 4000, 7488, steps) if c <= steps})


def drift(steps: int, model_kind: str, device="cuda"):
    """March fp64 and fp32 to each checkpoint; returns rows (steps,
    drift_l2, drift_max, analytic err fp64, analytic err fp32) and the two
    models."""
    from ..analysis.analytical import planewave
    from ..analysis.error import relative_l2_error

    m64, dt = build(model_kind, torch.float64, device)
    m32, _ = build(model_kind, torch.float32, device)
    rows = []
    t_prev = 0.0
    for nstep in checkpoints(steps):
        tf = nstep * dt
        m64.rk(t_prev, tf)
        m32.rk(t_prev, tf)
        t_prev = tf
        if m32.u_n.dtype != torch.float32 or m64.u_n.dtype != torch.float64:
            raise AssertionError(f"dtypes {m32.u_n.dtype}, {m64.u_n.dtype}")
        u64 = m64.u_n.double().cpu().numpy().reshape(-1)
        u32 = m32.u_n.double().cpu().numpy().reshape(-1)
        if not np.all(np.isfinite(u64)):
            raise RuntimeError(f"fp64 field non-finite at step {nstep}: the reduced problem blew "
                               "up; drift numbers would be meaningless")
        scale = max(float(np.max(np.abs(u64))), 1e-300)
        drift_max = float(np.max(np.abs(u32 - u64))) / scale
        drift_l2 = float(np.linalg.norm(u32 - u64) / max(np.linalg.norm(u64), 1e-300))
        if model_kind == "linear" and tf > 1.0 / C0 + 0.5:
            exact = lambda x: planewave(x[0], tf, C0, F0, P0)  # noqa: E731
            err64 = float(relative_l2_error(m64.ops, u64, exact))
            err32 = float(relative_l2_error(m32.ops, u32, exact))
        else:
            err64 = err32 = float("nan")
        rows.append((nstep, drift_l2, drift_max, err64, err32))
        print(f"steps {nstep:6d}: drift L2 {drift_l2:.3e} max {drift_max:.3e}"
              + ("" if np.isnan(err64) else
                 f"  analytic err fp64 {err64:.3e} fp32 {err32:.3e}"), flush=True)
    return rows, m64, m32


def table(rows, steps: int, model_kind: str, device_name: str) -> str:
    """The rows in the JAX tool's table format."""
    head = (f"# fp32 vs fp64 drift, reduced CW problem ({model_kind}, 2D channel 41x6 p=4, "
            f"{device_name}, {steps} steps)\n"
            "# produced by fenicsxfus_tpu_torch/tools/fp32_drift.py; gates as in "
            "tests/test_fp32_drift.py\n"
            "# steps  drift_l2  drift_max  analytic_err_fp64  analytic_err_fp32\n")
    return head + "".join(f"{r[0]:7d}  {r[1]:.4e}  {r[2]:.4e}  {r[3]:.4e}  {r[4]:.4e}\n"
                          for r in rows)


def gates(rows, model_kind: str) -> list[str]:
    """The failures of ``tests/test_fp32_drift.py``'s gates on ``rows``
    (empty if they pass): steps reach 7488, drift_l2 < 1e-4 from there on,
    and for linear the fp32 analytic error below twice the fp64 one."""
    r = np.asarray(rows, np.float64)
    fails = []
    if r[:, 0].max() < 7488:
        fails.append(f"the table ends at {int(r[:, 0].max())} steps, before 7488")
    late = r[r[:, 0] >= 7488]
    if not np.all(late[:, 1] < 1e-4):
        fails.append(f"drift_l2 {late[:, 1]} not < 1e-4 from 7488 steps on")
    if model_kind == "linear":
        ok = np.isfinite(r[:, 3])
        if not np.all(r[ok, 4] < 2.0 * r[ok, 3]):
            fails.append(f"fp32 analytic error {r[ok, 4]} not < 2x fp64's {r[ok, 3]}")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--model", default="linear", choices=("linear", "westervelt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the table here")
    args = ap.parse_args(argv)
    rows, m64, _ = drift(args.steps, args.model, args.device)
    dev = m64.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    text = table(rows, args.steps, args.model, name)
    print(text, end="")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    fails = gates(rows, args.model)
    for msg in fails:
        print(f"gate failed: {msg}")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
