"""End-to-end solver throughput, the ``measure_solver_speed`` analogue: the
port of ``benchmarks/solver_speed.py`` (reference
``cpp/*/experiments/measure_solver_speed``: 3D linear p = 4, 70.9M DOF, 101
and 201 RK4 steps; best reference 58.6 s / 117.2 s on a 76-process Icelake
node).

The model (linear, lossy or Westervelt) on ``create_box((nx,)*3)`` over
0.12 m, p = 4, fp32, source on x = 0 and ABC on x = L; one warm-up step,
then ``steps`` RK4 steps from zero, timed on the host clock to a device
sync; the model is left at the reached state and returned (``"eqn"``). On
the card each stage is one K2 launch; the bound of a step is the
sum of its four stages' (``tools/bounds.py::stage_floor`` on each stage's
own operands, read from one probe step).

    python -m fenicsxfus_tpu_torch.tools.solver_speed [--nx 104] [--steps 101] [--model westervelt]

On the CPU (``--device cpu``) the plain path runs and nothing is timed.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.mesh import create_box, tag_boundaries
from ..models.common import run_steps
from ..models.linear import LinearSpectralExplicit
from ..models.lossy import LossySpectralExplicit
from ..models.westervelt import WesterveltSpectralExplicit
from ..ops.stage import stage_apply
from ..utils import compute_diffusivity_of_sound, resolve_device
from .bounds import stage_floor

def build(nx: int = 104, model: str = "linear", device="cuda"):
    """The benchmark's model, initialised: (model, dt)."""
    c0, rho0, f0, p0, L = 1500.0, 1000.0, 0.5e6, 6e4, 0.12
    degree = 4
    mesh = create_box((nx, nx, nx), (0, 0, 0), (L, L, L))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > L - 1e-9})
    h = L / nx
    dt = 0.9 * h / (c0 * degree**2)
    delta0 = compute_diffusivity_of_sound(2 * np.pi * f0, c0, 0.3)
    f32 = dict(dtype=torch.float32, device=device)
    if model == "linear":
        eqn = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt, **f32)
    elif model == "lossy":
        eqn = LossySpectralExplicit(mesh, None, degree, c0, rho0, delta0, f0, p0, c0, 4, dt,
                                    **f32)
    elif model == "westervelt":
        eqn = WesterveltSpectralExplicit(mesh, None, degree, c0, rho0, delta0, 3.5, f0, p0, c0,
                                         4, dt, **f32)
    else:
        raise ValueError(f"model {model!r}: linear, lossy or westervelt")
    eqn.init()
    return eqn, dt


def step_bound_ms(eqn) -> float:
    """The bound of one fused RK4 step: the sum of its stages' bounds on
    their own operands (one probe step from the model's state, which is
    left as it was)."""
    bounds = []

    def probe(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final):
        args = dict(kind=kind, u0=u0, v0=v0, kvp=kvp, kvpp=kvpp, prev=prev, Fs=Fs, dense=dense,
                    facets=facets, scal=scal, p=p, final=final)
        bounds.append(stage_floor(args, "K2")["bound_ms"])
        return stage_apply(**args)

    gd = eqn.ops.gdims
    run_steps(eqn.fused_step(stage_fn=probe), eqn.consts, eqn.u_n.view(gd), eqn.v_n.view(gd),
              0.0, [eqn.dt])
    return float(sum(bounds))


def main(nx=104, steps=101, model="linear", device="cuda") -> dict:
    device = resolve_device(device)
    eqn, dt = build(nx, model, device)
    eqn._build()
    n = eqn.number_of_dofs()
    bound = step_bound_ms(eqn) if eqn.step_kind == "fused" else None
    u, v, _ = eqn._solve(eqn.consts, eqn.u_n, eqn.v_n, 0.0, dt, dt)  # warm-up: one step
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    u, v, tf = eqn._solve(eqn.consts, eqn.u_n, eqn.v_n, 0.0, steps * dt, dt)
    eqn.u_n, eqn.v_n, eqn.t = u, v, float(tf)  # the reached state, as ``rk`` leaves it
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0
        rate = n * steps / elapsed / 1e9
        share = None if bound is None else bound * steps / (elapsed * 1e3)
        against = "" if bound is None else f", bound {bound:.3f} ms/step, share {share:.3f}"
        print(f"{model}: {n / 1e6:.1f}M DOF, {steps} RK4 steps: {elapsed:.3f} s "
              f"({elapsed / steps * 1e3:.2f} ms/step, {rate:.3f} GDOF-steps/s; "
              f"{eqn.step_kind} step{against}; {torch.cuda.get_device_name(device)})")
    else:
        elapsed = rate = share = None
        print(f"{model}: {n / 1e6:.3f}M DOF, {steps} RK4 steps on the CPU ({eqn.step_kind} "
              "step): not timed")
    print("reference best (sf-naive, 76-proc node, 70.9M/101): 58.6 s = 0.122 GDOF-steps/s")
    if not bool(torch.isfinite(u).all()):
        raise RuntimeError(f"{model}: the state is not finite after {steps} steps")
    return {"model": model, "ndofs": n, "steps": steps, "seconds": elapsed, "rate": rate,
            "bound_ms_step": bound, "share": share, "step_kind": eqn.step_kind, "u": u, "t": tf,
            "eqn": eqn}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=104)
    ap.add_argument("--steps", type=int, default=101)
    ap.add_argument("--model", default="linear", choices=["linear", "lossy", "westervelt"])
    ap.add_argument("--device", default="cuda")
    main(**vars(ap.parse_args()))
