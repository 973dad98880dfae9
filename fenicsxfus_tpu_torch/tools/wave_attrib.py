"""The whole-step wavefront K3 against the four K2 launches of the same RK4
step: the port of ``benchmarks/wave_attrib.py``. Is a step through K3 slower
than four K2 launches because of the kernel, or because of the loop that
drives it?

On the script's linear model (``tools/phase_breakdown.py::build``:
``create_box((nx,)*3)`` over 0.12 m, p = 4, fp32; the default 104³ cells,
417³ = 72,511,713 DOF) built under ``FUS_STEP_WAVE=1``, from u = 0, v =
1e-6:

  K3 chained   ``step_wave_apply`` called ``chain`` times back to back on
               the model's operands and the step table of its first step
  real rk      the model's K3 step through its own loop (``model._solve``,
               what ``rk`` runs, with each step's source coefficients)
  real loop    the same step from ``model._make_step()`` in a plain Python
               loop (the JAX script's ``lax.scan`` against ``fori_loop``)
  four K2      the same RK4 step as four K2 launches (``FusedRKStage``),
               through the model's loop

each as ms a step by CUDA events (the least of ``reps`` runs of ``chain``
steps after a warm-up) and GDOF-steps/s. K3's plan
(``ops/step_wave.py::wave_plan``: tile, slab, lag, ring of the slopes) is
printed where the JAX script printed its VMEM block size. After ``chain``
steps from the same state the K3 and four-K2 states are compared (``k3_vs_k2``:
every kernel rounds alike, so 0 on the card).

    python -m fenicsxfus_tpu_torch.tools.wave_attrib [--nx 104] [--chain 10]

On the CPU (``--device cpu``) K3 runs its plain version (four plain
stages) and nothing is timed.
"""

from __future__ import annotations

import contextlib
import os

import torch

from ..models.common import make_scan_from_step
from ..ops.stage import KIND_FIELDS, KIND_RAW, FusedRKStage
from ..ops.step_wave import FusedRKStepWave, step_wave_apply, step_wave_check, wave_plan
from ..scripts import cli
from .phase_breakdown import build, march, rel
from .solver_speed import step_bound_ms
from .variants import best_ms


@contextlib.contextmanager
def step_wave(on: bool):
    """``FUS_STEP_WAVE`` set to 1 (or 0) for the block, as it was after."""
    old = os.environ.get("FUS_STEP_WAVE")
    os.environ["FUS_STEP_WAVE"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("FUS_STEP_WAVE")
        else:
            os.environ["FUS_STEP_WAVE"] = old


def fused(model, wave: bool, stage_fn=None):
    """The model's fused step through K3 (``wave``) or four K2 launches,
    built as ``FUS_STEP_WAVE`` selects it; the model's own step is not
    changed."""
    old_cls = model.stage_cls
    with step_wave(wave):
        step = model.fused_step(stage_fn=stage_fn)
    cls, model.stage_cls = model.stage_cls, old_cls
    if step is None or cls is not (FusedRKStepWave if wave else FusedRKStage):
        raise RuntimeError(f"{type(model).__name__}: no {'K3' if wave else 'K2'} step")
    return step


def paths(model, nsteps: int) -> dict:
    """(u, v) after ``nsteps`` steps from the model's state through K3,
    through four K2 launches and through the unfused step (K1 a stage)."""
    return {"K3": march(fused(model, True), model, nsteps),
            "K2": march(fused(model, False), model, nsteps),
            "unfused": march(model.unfused_step(), model, nsteps)}


def main(nx: int = 104, chain: int = 10, reps: int = 3, dtype=None, device="cuda", *,
         hold=None) -> dict:
    """The rows (ms a step, None on the CPU) and ``k3_vs_k2``. ``hold(model,
    args)``, if given, sees the model at u = 0, v = 1e-6 and the chained
    K3 call's keyword arguments before the timings."""
    kind = "linear"
    with step_wave(True):
        model = build(nx, kind, dtype, device)
    if model.stage_cls is not FusedRKStepWave:
        raise RuntimeError(f"the model did not take the K3 step ({model.stage_cls})")
    ops, dev, dt = model.ops, model.u_n.device, model.dt
    gd, p, n = ops.gdims, model.degree, model.number_of_dofs()
    nf = KIND_FIELDS[kind]
    plan = wave_plan(gd, p, nf, ops.dtype, nr=KIND_RAW[nf])
    sep = "inv_m__sep0" in model.consts
    print(f"gdims={gd} dofs={n / 1e6:.1f}M kind={kind} inv_m separable={sep}; K3 plan {plan}")
    model.u_n = torch.zeros(n, dtype=ops.dtype, device=dev)
    model.v_n = torch.full((n,), 1e-6, dtype=ops.dtype, device=dev)

    # the chained K3 call: the model's operands, its first step's table
    captured = {}

    def capture(kind_, u0, v0, scal4, Fs, dense, facets, p_):
        captured.update(kind=kind_, u0=u0, v0=v0, scal4=scal4, Fs=Fs, dense=dense,
                        facets=facets, p=p_)
        return step_wave_apply(kind_, u0, v0, scal4, Fs, dense, facets, p_)

    march(fused(model, True, stage_fn=capture), model, 1)
    args = {k: v for k, v in captured.items() if k not in ("u0", "v0")}
    if hold is not None:
        hold(model, dict(captured))

    def raw(k):
        u, v = model.u_n.view(gd), model.v_n.view(gd)
        for _ in range(k):
            u, v = step_wave_apply(u0=u, v0=v, **args)

    def through(solve):
        return lambda k: solve(model.consts, model.u_n, model.v_n, 0.0, k * dt, dt)

    def loop(step):
        def run(k):
            carry = (model.u_n.view(gd), model.v_n.view(gd), 0.0)
            for _ in range(k):
                carry = step(model.consts, carry, dt)
        return run

    with step_wave(True):
        real = model._make_step()
    runs = {"K3 chained": raw,
            "real rk": through(model._solve),
            "real loop": loop(real),
            "four K2": through(make_scan_from_step(fused(model, False)))}
    bound = step_bound_ms(model) if dev.type == "cuda" else None
    rows = {}
    for name, run in runs.items():
        ms = best_ms(run, chain, reps, dev)
        ms = None if ms is None else ms / chain
        rows[name] = {"ms": ms, "rate": None if ms is None else n / (ms * 1e-3) / 1e9,
                      "bound_ms": bound, "share": None if ms is None or bound is None
                      else bound / ms}
        if ms is None:
            print(f"  {name}: not measured")
        else:
            print(f"  {name}: {ms:.3f} ms/step -> {rows[name]['rate']:.3f} GDOF-steps/s")
    if dev.type == "cuda":
        step_wave_check()
    got = paths(model, chain)
    k3_vs_k2 = max(rel(a, b) for a, b in zip(got["K3"], got["K2"]))
    print(f"  K3 against four K2 after {chain} steps from the same state: max rel diff "
          f"{k3_vs_k2:.3e}")
    return {"kind": kind, "ndofs": n, "gdims": gd, "plan": plan, "sep": sep, "rows": rows,
            "k3_vs_k2": k3_vs_k2, "chain": chain}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
