"""The marginal cost of one more operand pass through K2, the fused RK
stage: the port of ``benchmarks/stage_attrib.py``.

The four stages of a fused RK4 step read different numbers of state fields
(stage i reads u0, v0 and up to two previous slopes; the final stage also
writes two outputs) but do the same compute. Timing K2 ``linear`` with 0, 1
and 2 slope operands on the same lattice therefore measures the cost of one
more field-sized pass through the kernel. The lattice is the headline's
(``create_box((nx,)*3)`` over 0.12 m, p = 4, fp32); the operands are the
model's own (packed coefficient, inverse mass, facet vectors) with a seeded
random u0, so that the stiffness term is not small beside the facet terms
when the kernel is held against its plain version. Each variant
is first held against ``stage_plain`` on the same operands, then timed
(``tools/variants.py::median_ms`` and ``device_ms``) beside its bound
(``tools/bounds.py::stage_floor``).

    python -m fenicsxfus_tpu_torch.tools.stage_attrib [--nx 104]

On the CPU (``--device cpu``) the plain stage runs and nothing is timed.
"""

from __future__ import annotations

import argparse

import torch

from ..core.mesh import create_box, tag_boundaries
from ..models.linear import LinearSpectralExplicit
from ..ops.stage import KIND_DENSE, KIND_FACET, stage_apply, stage_plain
from ..utils import resolve_device
from .bounds import stage_floor
from .variants import card_ms

# (name, passes: the fields read and written)
VARIANTS = (("stage0 (R2 W1, 3 passes)", 0), ("stage1 (R3 W1, 4 passes)", 1),
            ("stage2 (R4 W1, 5 passes)", 2))


def operands(nx: int = 104, device="cuda") -> list[dict]:
    """``stage_apply``'s keyword arguments for 0, 1 and 2 slope operands on
    the headline model's lattice (its own coefficient, inverse mass and
    facets; a seeded random u0, v0 and the slopes 1e-6, α = 1e-12, β and
    the source coefficient 0, as the JAX script takes them)."""
    device = resolve_device(device)
    c0, rho0, f0, p0 = 1500.0, 1000.0, 0.5e6, 60000.0
    L, degree = 0.12, 4
    mesh = create_box((nx, nx, nx), (0, 0, 0), (L, L, L))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > L - 1e-9})
    dt = 0.9 * (L / nx) / (c0 * degree**2)
    model = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                   dtype=torch.float32, device=device)
    model.init()
    if model.fused_step() is None:  # packs the facet vectors
        raise RuntimeError("the headline model did not build its fused step")
    c, gd = model.consts, model.ops.gdims
    gen = torch.Generator(device=device).manual_seed(0)
    u0 = torch.randn(gd, generator=gen, device=device, dtype=torch.float32)
    v0 = torch.full(gd, 1e-6, dtype=torch.float32, device=device)
    kv = torch.full(gd, 1e-6, dtype=torch.float32, device=device)
    common = dict(kind="linear", u0=u0, prev=None,
                  Fs=[c[k] for k in LinearSpectralExplicit.STIFF_KEYS],
                  dense=[c[k].view(gd) for k in KIND_DENSE["linear"]],
                  facets=[c[k + "__pf"] for k in KIND_FACET["linear"]],
                  scal=[1e-12, 0.0, 0.0], p=degree, final=False)
    slopes = [(v0, None, None), (v0, kv, None), (v0, kv, v0.clone())]
    return [dict(common, v0=a, kvp=b, kvpp=d) for a, b, d in slopes]


def measure(args_list: list[dict]) -> list[dict]:
    """Each variant against ``stage_plain`` (``rel``), its times (None on
    the CPU), bound and share."""
    out = []
    for (name, passes), args in zip(VARIANTS, args_list):
        got, ref = stage_apply(**args), stage_plain(**args)
        rel = float((got - ref).abs().max() / ref.abs().max())
        del got, ref
        t = card_ms(lambda: stage_apply(**args), args["u0"].device)
        bound = stage_floor(args, "K2")
        out.append({"name": name, "slopes": passes, "rel": rel, **t, **bound,
                    "share": None if t["ms"] is None else bound["bound_ms"] / t["ms"]})
    return out


def main(nx=104, device="cuda") -> dict:
    args_list = operands(nx, device)
    u0 = args_list[0]["u0"]
    n = u0.numel()
    field_mb = n * 4 / 1e6
    res = measure(args_list)
    print(f"DOFs={n / 1e6:.1f}M field={field_mb:.0f}MB degree=4 fp32")
    for r in res:
        ms = "not measured" if r["ms"] is None else f"{r['ms']:7.3f} ms"
        share = "" if r["share"] is None else f", share {r['share']:.3f}"
        print(f"{r['name']}  {ms} (device alone "
              f"{'not measured' if r['device_ms'] is None else format(r['device_ms'], '.3f')}), "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}){share}, vs plain {r['rel']:.2e}")
    out = {"rows": res, "ndofs": n}
    if res[0]["ms"] is not None:
        t0, t1, t2 = (r["ms"] for r in res)
        d1, d2 = t1 - t0, t2 - t1
        print(f"marginal pass cost        {d1:7.3f} / {d2:.3f} ms "
              f"({field_mb / 1e3 / max(d1 * 1e-3, 1e-12):.0f} / "
              f"{field_mb / 1e3 / max(d2 * 1e-3, 1e-12):.0f} GB/s)")
        # a RK4 step is 19 passes (3 + 4 + 5 + 7); pairwise fusion 10,
        # the 4-way wavefront 4 (+ geometry)
        dpp = (d1 + d2) / 2
        step = 4 * (t0 + dpp * 1.75)  # the mean stage: 4.75 passes
        print(f"per-step model (19 passes){step:7.3f} ms -> pair(10): {step - 9 * dpp:.3f} ms, "
              f"4-way(4+2): {step - 13 * dpp:.3f} ms")
        out.update(marginal_ms=(d1, d2), step_model_ms=step)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=104)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.nx, a.device)
