"""Single-operator apply timings across degrees at a fixed DOF count: the
port of ``benchmarks/operator_speed.py`` (reference
``cpp/fenicsx-sf/experiments/measure_fraction_of_peak_performance``: the
stiffness and mass applies at about 38.3M DOF for p = 2..6).

For each degree, a ``create_box`` lattice of about ``dofs`` DOF (G = 339,
337, 337, 336, 337 nodes a side for p = 2..6 at the default), fp32: the
stiffness apply with a constant and with a DG-0 coefficient, as
``SEMOperators`` runs it (K1; with ``FUS_V3=0`` in the environment K4a then
K4b, read at every apply), each first held against the plain apply on the
same input, and the lumped-mass divide. Each row gives the CUDA-event median
(``tools/variants.py::median_ms``), the device's time alone (``device_ms``),
the bound from the same inputs (``tools/bounds.py``) and the share of it.

    python -m fenicsxfus_tpu_torch.tools.operator_speed [--dofs 38.3e6] [--degrees 2,3,4,5,6]

On the CPU (``--device cpu``) the plain applies run and nothing is timed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.mesh import create_box
from ..ops.operators import SEMOperators
from ..ops.stiffness import pack_const, pack_field, stiffness_apply, stiffness_plain
from ..utils import resolve_device
from .bounds import floor_ms, nbytes, stencil_flops
from .variants import card_ms


def pipeline() -> str:
    """The stiffness kernels an apply takes now (``FUS_V3``)."""
    return "K4a+K4b" if os.environ.get("FUS_V3", "1") == "0" else "K1"


def setup(degree: int, dofs: float = 38.3e6, device="cuda", seed: int = 0) -> dict:
    """The operands of one degree's rows: the lattice operators, a seeded
    random field x, the constant and DG-0 coefficients (1 and 1 + 0.3 sin of
    the cell index) and the inverse lumped mass."""
    device = resolve_device(device)
    nx = max(int(round(dofs ** (1 / 3) / degree)), 2)
    mesh = create_box((nx, nx, nx), (0, 0, 0), (0.12, 0.12, 0.12))
    ops = SEMOperators(mesh, degree, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(ops.gdims, generator=gen, device=device, dtype=torch.float32)
    het = 1.0 + 0.3 * np.sin(np.arange(mesh.num_cells))
    minv = 1.0 / ops.to_device(ops.assemble_diag(1.0)).view(ops.gdims)
    return {"degree": degree, "ops": ops, "x": x, "minv": minv,
            "coeffs": {"const": pack_const(ops.lattice, 1.0, device),
                       "DG-0": pack_field(ops.lattice, het, device)}}


def rows(s: dict) -> list[dict]:
    """The stiffness rows (constant, DG-0) and the mass row of one degree's
    operands, through the pipeline the environment selects: each stiffness
    apply's max|y - y_plain|/max|y_plain| (``rel``), its times (None on the
    CPU), bound and share."""
    ops, x, p = s["ops"], s["x"], s["degree"]
    gd = ops.gdims
    out = []
    for name, F in s["coeffs"].items():
        y, ref = stiffness_apply([x], [F], p), stiffness_plain([x], [F], p)
        rel = float((y - ref).abs().max() / ref.abs().max())
        del y, ref
        t = card_ms(lambda: stiffness_apply([x], [F], p), x.device)
        bound = floor_ms(nbytes(x, F), nbytes(x), stencil_flops(gd, p, 1, (0, 1, 2)))
        out.append({"op": f"stiffness {name}", "pipeline": pipeline(), "rel": rel, **t,
                    **bound})
    minv = s["minv"]
    t = card_ms(lambda: x * minv, x.device)
    out.append({"op": "mass divide", "pipeline": "torch", "rel": None, **t,
                **floor_ms(nbytes(x, minv), nbytes(x), float(x.numel()))})
    for r in out:
        r.update(degree=p, ndofs=ops.ndofs, gdims=gd,
                 share=None if r["ms"] is None else r["bound_ms"] / r["ms"])
    return out


def row_text(r: dict) -> str:
    def ms(v):
        return "not measured" if v is None else f"{v:.3f}"

    rel = "" if r["rel"] is None else f", vs plain {r['rel']:.2e}"
    share = "" if r["share"] is None else f", share {r['share']:.3f}"
    return (f"p={r['degree']} {r['ndofs'] / 1e6:.2f}M DOF {r['gdims']}: {r['op']} "
            f"({r['pipeline']}) {ms(r['ms'])} ms, device alone {ms(r['device_ms'])} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}){share}{rel}")


def main(dofs=38.3e6, degrees=(2, 3, 4, 5, 6), device="cuda") -> list[dict]:
    device = resolve_device(device)
    if device.type == "cuda":
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(f"card: {card.strip()}")
    out = []
    for degree in degrees:
        s = setup(degree, dofs, device)
        for r in rows(s):
            print(row_text(r), flush=True)
            out.append(r)
        del s
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dofs", type=float, default=38.3e6)
    ap.add_argument("--degrees", type=str, default="2,3,4,5,6")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.dofs, tuple(int(d) for d in a.degrees.split(",")), a.device)
