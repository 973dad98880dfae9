"""The host setup of the headline problem, phase by phase: the port of
``benchmarks/setup_speed.py`` (reference analogue
``cpp/*/experiments/measure_vector_assembly_speed``).

The mass diagonal, the facet vectors and the packed stiffness coefficient
are assembled once, on the host, before the time loop; what a user waits
for is that one-time setup at production size. On ``create_box((nx,)*3)``
over 0.12 m at degree p (the default 104³ cells at p = 4: 417³ =
72,511,713 DOF), source on x = 0 and ABC on x = L, fp32, each phase is timed
on the host clock in the JAX script's order:

  imports        the port's modules that this process had not loaded yet
                 (run as a file in a fresh process: torch and the package)
  mesh           ``create_box``
  tags           ``tag_boundaries``
  operators      ``SEMOperators`` (space, dofmap, lattice, one cell's
                 geometry)
  mass_diag      ``assemble_diag(1.0)``
  facet_vectors  ``facet_vector`` of tags 1 and 2
  stiff_coeff    ``stiff_coeff(1.0)`` (packed on the device)
  upload         the mass and facet vectors to the device, to a sync

    python3 fenicsxfus_tpu_torch/tools/setup_speed.py [--nx 104] [--degree 4]
        [--device cuda] [--out setup.json]

On the CPU (``--device cpu``) the same phases run on the host (the upload is
a copy).
"""

from __future__ import annotations

import functools
import json
import sys
import time
from pathlib import Path

PHASES = ("imports", "mesh", "tags", "operators", "mass_diag", "facet_vectors", "stiff_coeff",
          "upload")


def main(nx: int = 104, degree: int = 4, dtype=None, device="cuda", out: str | None = None, *,
         imported_s: float = 0.0) -> dict:
    """Time the phases; returns {"rows": [(phase, s)], "total_s", "ndofs",
    "num_cells", "vectors": the mass and facet vectors on the device and the
    packed coefficient}; ``out`` writes all but the vectors as JSON.
    ``imported_s``: seconds the caller spent importing the package just
    before (the command line's, run as a file), counted in "imports"."""
    t = {}

    def clock(name):
        t[name] = time.perf_counter()

    clock("t0")
    import torch

    from fenicsxfus_tpu_torch.core.mesh import create_box, tag_boundaries
    from fenicsxfus_tpu_torch.ops.operators import SEMOperators
    from fenicsxfus_tpu_torch.utils import resolve_device

    clock("imports")
    dev = resolve_device(device)
    L = 0.12
    mesh = create_box((nx, nx, nx), (0, 0, 0), (L, L, L))
    clock("mesh")
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > L - 1e-9})
    clock("tags")
    ops = SEMOperators(mesh, degree, dtype=dtype or torch.float32, device=dev)
    clock("operators")
    m = ops.assemble_diag(1.0)
    clock("mass_diag")
    src = ops.facet_vector(1, 1.0)
    abc = ops.facet_vector(2, 1.0)
    clock("facet_vectors")
    coeff = ops.stiff_coeff(1.0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    clock("stiff_coeff")
    vectors = {"mass": ops.to_device(m), "src": ops.to_device(src), "abc": ops.to_device(abc),
               "coeff": coeff}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    clock("upload")

    rows = []
    prev = "t0"
    for name in PHASES:
        rows.append((name, t[name] - t[prev] + (imported_s if name == "imports" else 0.0)))
        prev = name
    total = sum(s for _, s in rows)
    print(f"setup timings, 3D p={degree}, {nx}^3 cells, {ops.ndofs / 1e6:.1f}M DOF "
          f"({mesh.num_cells / 1e3:.0f}k cells), {ops.dtype}, {dev}")
    for name, s in rows:
        print(f"  {name:>14}: {s:8.3f} s")
    print(f"  {'TOTAL':>14}: {total:8.3f} s")
    if not (bool(torch.isfinite(vectors["mass"]).all()) and float(vectors["src"].max()) > 0
            and float(vectors["abc"].max()) > 0):
        raise RuntimeError("setup_speed: the assembled vectors are not finite and positive")
    res = {"nx": nx, "degree": degree, "ndofs": ops.ndofs, "num_cells": mesh.num_cells,
           "rows": rows, "total_s": total}
    if out:
        Path(out).write_text(json.dumps(res, indent=1))
    return {**res, "vectors": vectors}


if __name__ == "__main__":
    t_start = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from fenicsxfus_tpu_torch.scripts import cli

    cli(functools.partial(main, imported_s=time.perf_counter() - t_start),
        __doc__.splitlines()[0])
