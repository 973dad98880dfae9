"""h-convergence of the bowl-fitted mesh against the O'Neil axial solution:
the port of ``benchmarks/hitu/bowl_convergence_cpu.py``.

H101 on the bowl-fitted mesh (``drivers/hitu.py::validate_bowl_mesh``: the
linear Westervelt model, β = δ = 0, K2 with its band operand a stage) at
200 kHz, in fp64, at nx = 20, 28 and 36 (194,481 / 477,425 / 1,047,625
DOF): the focal-gain error, the focal position error and the focal-region
L2 error of each against O'Neil (1949), as a table. Each row is also held
against the JAX package's own run of the same problem in fp64 on a CPU
(``bowl_convergence_jax.json`` beside this file: its values, the JAX
package's commit and the command that made them; ``held``: the largest
absolute difference of the three numbers, in their own units, the position
in m).

    python -m fenicsxfus_tpu_torch.drivers.bowl_convergence [--nx 20,28,36]
        [--f0 200e3] [--out DIR]

With ``--out`` each run is written as ``DIR/oneil_bowlmesh_nx{nx}.npz``;
nothing is written otherwise. The runs are fp64 on the card and on the CPU
unless ``--dtype`` says otherwise; on the CPU they take minutes each.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from ..scripts import cli, device_dtype
from .hitu import validate_bowl_mesh

REFERENCE = Path(__file__).with_name("bowl_convergence_jax.json")


def reference() -> dict:
    """The JAX package's values by nx: {"gain_err", "pos_err" (m),
    "profile_err"}."""
    return {int(k): v for k, v in json.loads(REFERENCE.read_text())["runs"].items()}


def main(nx: str = "20,28,36", f0: float = 200e3, dtype=None, device="cuda",
         out: str | None = None) -> dict:
    """The rows (nx, gain error, position error in m, L2 error, and
    ``held`` against the JAX package's run where it has one at ``f0``)."""
    dev, dtype = device_dtype(device, dtype or torch.float64)
    ref = reference() if f0 == 200e3 else {}
    rows = []
    for n in (int(s) for s in nx.split(",")):
        path = os.path.join(out, f"oneil_bowlmesh_nx{n}.npz") if out else None
        g, p, l2 = validate_bowl_mesh("H101", f0=f0, nx=n, out=path, dtype=dtype, device=dev)
        r = ref.get(n)
        held = None if r is None else max(abs(g - r["gain_err"]), abs(p - r["pos_err"]),
                                          abs(l2 - r["profile_err"]))
        rows.append({"nx": n, "gain_err": g, "pos_err": p, "profile_err": l2, "held": held})
    print(f"\nh-convergence (H101 bowl-fitted mesh, {f0 / 1e3:.0f} kHz, {dtype}, {dev}):")
    for r in rows:
        against = "" if r["held"] is None else f"  (JAX package's run: max |d| {r['held']:.2e})"
        print(f"  nx={r['nx']:3d}: gain {r['gain_err'] * 100:5.2f}%  pos "
              f"{r['pos_err'] * 1e3:5.2f} mm  focal L2 {r['profile_err'] * 100:5.2f}%{against}")
    return {"f0": f0, "dtype": str(dtype), "rows": rows}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
