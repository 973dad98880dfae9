"""The cost of one RK4 step, phase by phase (the reference's
``measure_bottlenecks``): the port of ``benchmarks/phase_breakdown.py``.

For the linear, lossy and Westervelt models on ``create_box((nx,)*3)`` over
0.12 m, p = 4, fp32 (the default 104³ cells: 417³ = 72,511,713 DOF), source
on x = 0 and ABC on x = L, each model built once:

  step       the fused RK4 step (K2 a stage) through the model's own loop
             (``model._solve``, what ``rk`` runs), as the slope between N
             and 2N steps
  stage      the step / 4
  stiffness  K1 alone (``ops/stiffness.py::stiffness_apply``) on a seeded
             random field, chained, its coefficient 1/r with r the growth
             of one apply (the JAX script's spectral normalisation, so that
             the chained values stay of order 1)
  pointwise  the mass divide plus one AXPY, z / m + 0.5 z, chained
  unfused    the unfused RK4 step (``model.unfused_step()``, the step
             ``FUS_FUSED=0`` selects: K1 a stage plus torch passes, where
             the JAX script times its unfused XLA rhs), as the slope between
             N/2 and N steps (the JAX script chains its rhs 10 and 20 times)

Times are CUDA events (``tools/variants.py::slope_ms``: the least of 3 runs
after a warm-up); each row has its bound (``tools/bounds.py``: the step's
from its four stages' own operands). The model is left at the state the
timed steps reached, from which ``check_steps`` steps through the fused and
through the unfused step are held together (``held``).

    python -m fenicsxfus_tpu_torch.tools.phase_breakdown [--nx 104]
        [--kinds linear,lossy,westervelt] [--steps 20]

On the CPU (``--device cpu``) the plain path runs and nothing is timed.
"""

from __future__ import annotations

import torch

from ..core.mesh import create_box, tag_boundaries
from ..models.common import make_scan_from_step, run_steps
from ..models.linear import LinearSpectralExplicit
from ..models.lossy import LossySpectralExplicit
from ..models.westervelt import WesterveltSpectralExplicit
from ..ops.stiffness import pack_const, stiffness_apply
from ..scripts import cli, device_dtype
from .bounds import floor_ms, nbytes, stencil_flops
from .solver_speed import step_bound_ms
from .variants import slope_ms

# model class and its extra arguments (δ, β) as the JAX script takes them
KINDS = {
    "linear": (LinearSpectralExplicit, ()),
    "lossy": (LossySpectralExplicit, (4e-3,)),
    "westervelt": (WesterveltSpectralExplicit, (4e-3, 3.5)),
}


def build(nx: int = 104, kind: str = "linear", dtype=None, device="cuda"):
    """The script's model of ``kind``, initialised, its step built."""
    dev, dtype = device_dtype(device, dtype, cpu_dtype=torch.float32)
    c0, rho0, f0, p0 = 1500.0, 1000.0, 0.5e6, 60000.0
    L, degree = 0.12, 4
    mesh = create_box((nx, nx, nx), (0, 0, 0), (L, L, L))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > L - 1e-9})
    dt = 0.9 * (L / nx) / (c0 * degree**2)
    cls, extra = KINDS[kind]
    model = cls(mesh, None, degree, c0, rho0, *extra, f0, p0, c0, 4, dt, dtype=dtype, device=dev)
    model.init()
    model._build()
    return model


def march(step, model, nsteps: int):
    """(u, v) after ``nsteps`` steps of ``step`` from the model's state
    (which is left as it was), in the model's flat layout."""
    shape = getattr(step, "carry_shape", None) or (-1,)
    u, v, _ = run_steps(step, model.consts, model.u_n.view(shape), model.v_n.view(shape),
                        model.t, [model.dt] * nsteps)
    return u.reshape(-1), v.reshape(-1)


def rel(a, b) -> float:
    """max |a - b| / max |b|, in float64."""
    d = float((a.double() - b.double()).abs().max())
    return d / max(float(b.double().abs().max()), 1e-300)


def measure(model, nsteps: int = 20, check_steps: int = 3) -> dict:
    """The rows of one model (ms None on the CPU), and ``held``: the fused
    and unfused steps' max rel difference after ``check_steps`` steps from
    the reached state."""
    ops, dev, dt = model.ops, model.u_n.device, model.dt
    gd, p = ops.gdims, model.degree
    n = model.number_of_dofs()
    u0, v0 = model.u_n, model.v_n

    def steps(solve):
        return lambda k: solve(model.consts, u0, v0, 0.0, k * dt, dt)

    fused = model._solve
    unfused = make_scan_from_step(model.unfused_step())
    step_bound = step_bound_ms(model) if model.step_kind == "fused" else None
    step = slope_ms(steps(fused), nsteps, device=dev)
    unfused_ms = slope_ms(steps(unfused), max(nsteps // 2, 1), device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    xr = torch.randn(gd, generator=gen, device=dev, dtype=ops.dtype)
    one = pack_const(ops.lattice, 1.0, dev)
    r = float(stiffness_apply([xr], [one], p).abs().max() / xr.abs().max())
    Fc = pack_const(ops.lattice, 1.0 / r, dev)

    def stiff(k):
        y = xr
        for _ in range(k):
            y = stiffness_apply([y], [Fc], p)

    m = 1.0 + u0.view(gd).abs()

    def pointwise(k):
        z = xr
        for _ in range(k):
            z = z / m + 0.5 * z

    stiff_ms = slope_ms(stiff, 10, device=dev)
    point_ms = slope_ms(pointwise, 10, device=dev)
    rows = {
        "step": (step, step_bound),
        "stage": (None if step is None else step / 4,
                  None if step_bound is None else step_bound / 4),
        "stiffness": (stiff_ms, floor_ms(nbytes(xr, Fc), nbytes(xr),
                                         stencil_flops(gd, p, 1, (0, 1, 2)))["bound_ms"]),
        "pointwise": (point_ms, floor_ms(nbytes(xr, m), nbytes(xr), 3.0 * n)["bound_ms"]),
        "unfused": (unfused_ms, step_bound),
    }
    # the state the timed runs reach, then the fused and unfused steps from it
    u, v, t = fused(model.consts, u0, v0, 0.0, 2 * nsteps * dt, dt)
    model.u_n, model.v_n, model.t = u, v, float(t)
    uf, vf = march(model._make_step(), model, check_steps)
    uu, vu = march(model.unfused_step(), model, check_steps)
    held = max(rel(uf, uu), rel(vf, vu))
    return {"kind": type(model).FUSED_KIND, "ndofs": n, "step_kind": model.step_kind,
            "rows": {k: {"ms": ms, "bound_ms": b,
                         "share": None if ms is None or b is None else b / ms}
                     for k, (ms, b) in rows.items()},
            "held": held, "check_steps": check_steps}


def text(res: dict) -> list[str]:
    def ms(v):
        return "not measured" if v is None else f"{v:8.3f} ms"

    rows, n = res["rows"], res["ndofs"]
    step = rows["step"]["ms"]
    stage = rows["stage"]["ms"]
    out = [f"kind={res['kind']} DOFs={n / 1e6:.1f}M degree=4 ({res['step_kind']} step)"]
    for name, label in (("step", "RK4 step"), ("stage", "  fused stage (=/4)"),
                        ("stiffness", "  stiffness apply"), ("pointwise", "  pointwise pass"),
                        ("unfused", "  unfused RK4 step")):
        r = rows[name]
        extra = ""
        if name == "step" and step:
            extra = f" ({n / step / 1e6:.2f} GDOF-steps/s)"
        elif name == "stiffness" and stage and r["ms"]:
            extra = f" ({r['ms'] / stage * 100:.0f}% of stage)"
        elif name == "unfused" and step and r["ms"]:
            extra = f" ({r['ms'] / step:.2f}x the fused step)"
        bound = "" if r["bound_ms"] is None else f", bound {r['bound_ms']:.3f} ms"
        share = "" if r["share"] is None else f", share {r['share']:.3f}"
        out.append(f"{label:<20}{ms(r['ms'])}{extra}{bound}{share}")
    out.append(f"  fused vs unfused, {res['check_steps']} steps from the reached state: max rel "
               f"diff {res['held']:.3e}")
    return out


def main(nx: int = 104, kinds: str = "linear,lossy,westervelt", steps: int = 20, dtype=None,
         device="cuda", *, hold=None) -> dict:
    """Each kind's rows by kind. ``hold(kind, model)``, if given, sees each
    model at its reached state before the next one is built."""
    out = {}
    for kind in kinds.split(","):
        model = build(nx, kind, dtype, device)
        res = measure(model, steps)
        for line in text(res):
            print(line, flush=True)
        if hold is not None:
            hold(kind, model)
        out[kind] = res
        del model
    return out


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
