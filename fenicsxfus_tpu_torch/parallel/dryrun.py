"""The multi-rank dry run: every decomposition of the port on tiny shapes.

The ``torch.distributed`` counterpart of ``__graft_entry__.py::
dryrun_multichip``: ``dryrun_multichip(world, backend, device)`` starts
``world`` ranks (``launch.spawn``) and runs on each, fp32, as the JAX dry run
does on its virtual devices:

* the slab: Westervelt on 2·world + 1 cells along x (an uneven partition:
  the last slabs hold padding), a full and a partial step, then recording at
  five sensors off the nodes;
* the implicit CG with reduced dots (``ShardedImplicitSolver``, linear
  SDIRK2, ``dirk`` and ``dirk_record``);
* the sponge (the nodal δ coefficient packed per slab);
* the (world/2, 2) grid when world is even and at least 4, the (2, 2, 2)
  grid and its sponge when world is at least 8;
* the distorted, vertex-scrambled box through the unstructured split, with
  recording;
* a bowl-fitted mesh through the slab (K1 on every rank, the band correction
  on rank 0).

Every field must come out finite; each rank returns what it ran, with the
sizes and the largest |u| of each part.

    python -m fenicsxfus_tpu_torch.parallel.dryrun --world 4 --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.bowl import create_bowl_box
from ..core.mesh import Mesh, create_box, tag_boundaries
from ..models.experimental import LinearSpectralSponge
from ..models.linear import LinearSpectralImplicit
from ..models.westervelt import WesterveltSpectralExplicit
from .grid import ShardedExplicitSolver2D
from .launch import spawn
from .slab import ShardedExplicitSolver, ShardedImplicitSolver
from .unstructured import ShardedUnstructuredExplicitSolver

C0, RHO0, F0, P0, DELTA0, BETA0 = 1500.0, 1000.0, 0.5e6, 60000.0, 4.0e-3, 3.5


def _tag(mesh):
    return tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})


def flagship(nx, degree: int, dtype, device):
    """The small 3D Westervelt model of the JAX dry run (``_flagship``) on a
    uniform box of ``nx`` cells over 1 × 0.5 × 0.5."""
    mesh = _tag(create_box(nx, (0, 0, 0), (1.0, 0.5, 0.5)))
    dt = 0.5 * (1.0 / nx[0]) / (C0 * degree**2)
    return WesterveltSpectralExplicit(mesh, None, degree, C0, RHO0, DELTA0, BETA0, F0, P0, C0, 4,
                                      dt, dtype=dtype, device=device).init()


def _sponge(mesh, degree: int, dt: float, dtype, device):
    sp = LinearSpectralSponge(mesh, None, degree, C0, RHO0, 8e-3, F0, P0, C0, sponge_start=0.7,
                              dtype=dtype, device=device)
    sp.dt = dt
    sp._build()
    return sp.init()


def _scrambled_box(n: int):
    """The box of 2n + 1 × 2 × 2 cells with its interior vertices jittered
    and its vertex ids permuted (seeded): an unstructured mesh."""
    base = create_box((2 * n + 1, 2, 2), (0, 0, 0), (1.0, 0.5, 0.5))
    rng = np.random.default_rng(0)
    verts = base.vertices.copy()
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    interior = np.all((verts > lo + 1e-12) & (verts < hi - 1e-12), axis=1)
    verts[interior] += 0.02 * (rng.random((int(interior.sum()), 3)) - 0.5)
    perm = rng.permutation(base.num_vertices)
    moved = np.empty_like(verts)
    moved[perm] = verts
    return _tag(Mesh(dim=3, vertices=moved, cells=perm[np.asarray(base.cells)]))


def _summary(u, v, ys=None) -> dict:
    uh, vh = u.detach().double().cpu().numpy(), v.detach().double().cpu().numpy()
    out = {"ndofs": int(uh.size), "max_u": float(np.max(np.abs(uh))),
           "finite": bool(np.all(np.isfinite(uh)) and np.all(np.isfinite(vh)))}
    if ys is not None:
        yh = ys.detach().double().cpu().numpy()
        out.update(sensors=list(yh.shape), finite=out["finite"] and bool(np.all(np.isfinite(yh))))
    return out


def rank_job(device, world: int, dtype_name: str = "float32") -> dict:
    """One rank of the dry run: each part in turn; {part: summary}."""
    dtype = getattr(torch, dtype_name)
    out = {}
    xs = np.linspace(0.1, 0.9, 5)
    pts = np.stack([xs, np.full_like(xs, 0.25), np.full_like(xs, 0.25)])

    model = flagship((2 * world + 1, 2, 2), 3, dtype, device)
    solver = ShardedExplicitSolver(model, device=device)
    u, v, t = solver.rk(0.0, 3.1 * model.dt)  # a full and a partial step
    out["slab"] = _summary(u, v)
    u, v, t, times, ys = solver.rk_record(t, t + 2.1 * model.dt, pts)
    out["slab_record"] = _summary(u, v, ys)

    mesh = _tag(create_box((2 * world, 2, 2), (0, 0, 0), (1.0, 0.5, 0.5)))
    dt = 0.5 / (2 * world) / C0
    imp = LinearSpectralImplicit(mesh, None, 3, C0, RHO0, F0, P0, C0, 2, dt, dtype=dtype,
                                 device=device).init()
    isv = ShardedImplicitSolver(imp, device=device)
    u, v, t = isv.dirk(0.0, 2.1 * imp.dt)
    out["implicit"] = _summary(u, v)
    u, v, t, times, ys = isv.dirk_record(t, t + 2.1 * imp.dt, pts)
    out["implicit_record"] = dict(_summary(u, v, ys), cg=imp.cg_stats["max_iterations"])

    sp = _sponge(mesh, 3, dt, dtype, device)
    out["sponge"] = _summary(*ShardedExplicitSolver(sp, device=device).rk(0.0, 2.1 * sp.dt)[:2])

    if world % 2 == 0 and world >= 4:
        m2d = flagship((world, world, 2), 2, dtype, device)
        u, v, _ = ShardedExplicitSolver2D(m2d, (world // 2, 2), device=device).rk(0.0, 2.1 * m2d.dt)
        out[f"grid {world // 2}x2"] = _summary(u, v)
    if world >= 8:
        m3d = flagship((4, 4, 4), 2, dtype, device)
        solver = ShardedExplicitSolver2D(m3d, (2, 2, 2), device=device)
        out["grid 2x2x2"] = _summary(*solver.rk(0.0, 2.1 * m3d.dt)[:2])
        sp3 = _sponge(_tag(create_box((4, 4, 4), (0, 0, 0), (1.0, 0.5, 0.5))), 2, 0.1 / 4 / C0,
                      dtype, device)
        solver = ShardedExplicitSolver2D(sp3, (2, 2, 2), device=device)
        out["grid 2x2x2 sponge"] = _summary(*solver.rk(0.0, 2.1 * sp3.dt)[:2])

    um = WesterveltSpectralExplicit(_scrambled_box(world), None, 2, C0, RHO0, DELTA0, BETA0, F0, P0,
                                    C0, 4, 0.4 / (2 * world + 1) / C0 / 4, dtype=dtype,
                                    device=device).init()
    su = ShardedUnstructuredExplicitSolver(um, device=device)
    u, v, t = su.rk(0.0, 2.1 * um.dt)
    out["unstructured"] = dict(_summary(u, v), partition=su.dec.partition_mode,
                               local_cells=len(su.dec.cells))
    u, v, t, times, ys = su.rk_record(t, t + 2.1 * um.dt, pts)
    out["unstructured_record"] = _summary(u, v, ys)

    bmesh, _ = create_bowl_box((4 * world, 4, 4), (0, 0, 0), (1.0, 0.5, 0.5), 0.9, 0.15,
                               blend=0.35 / world, lateral_hold=0.35 / world)
    hyb = WesterveltSpectralExplicit(bmesh, None, 2, C0, RHO0, DELTA0, BETA0, F0, P0, C0, 4,
                                     0.1 / (4 * world) / C0 / 4, dtype=dtype, device=device).init()
    if hyb.ops.hybrid is None:
        raise AssertionError("the bowl mesh did not take the hybrid path")
    sh = ShardedExplicitSolver(hyb, device=device)
    if (sh.dec.ops.hybrid is not None) != (sh.dec.rank == 0):
        raise AssertionError("the band correction must sit on rank 0 alone")
    out["bowl slab"] = _summary(*sh.rk(0.0, 2.1 * hyb.dt)[:2])
    bad = [k for k, r in out.items() if not r["finite"]]
    if bad:
        raise AssertionError(f"rank {sh.dec.rank}: non-finite fields in {bad}")
    return out


def dryrun_multichip(world: int, backend: str = "gloo", device="cuda",
                     dtype: str = "float32") -> list:
    """Run the dry run on ``world`` ranks (``backend`` gloo or nccl, on
    ``device``: the card unless the CPU is asked for); the ranks' results
    in rank order. Raises if a rank fails or a field is not finite."""
    return spawn(rank_job, world, backend, device, args=(world, dtype))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    a = ap.parse_args(argv)
    res = dryrun_multichip(a.world, a.backend, a.device, a.dtype)
    for part, r in res[0].items():
        print(f"{part}: {json.dumps(r)}")
    print(f"dry run ok on {a.world} ranks ({a.backend}, {a.device})")
    return res


if __name__ == "__main__":
    main()
