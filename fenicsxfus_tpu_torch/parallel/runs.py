"""Sharded runs described as data, for ranks started by ``launch.spawn``.

A case is a dict that names its mesh, model and run, so that it pickles to
the ranks and the same problem can be built elsewhere (on one device, or by
another implementation of the models):

* ``"mesh"``: ``("interval" | "rectangle" | "box", n, lo, hi)``,
  ``("bowl", args, kwargs)`` for ``create_bowl_box(*args, **kwargs)``,
  ``("deformed", n, lo, hi, seed, amplitude)``, a box lattice whose interior
  vertices are moved by up to ``amplitude`` (seeded), or ``("jittered", n,
  lo, hi, seed, amplitude, scramble)``, the same as an unstructured mesh (no
  ``grid_shape``), its vertex ids permuted by the same generator if
  ``scramble``; ``"as_unstructured": True`` passes the mesh through
  ``as_unstructured``;
* ``"decomp"``: ``slab`` (the default), ``grid`` over ``"dshape"`` or
  ``unstructured`` with ``"partition"`` (default ``auto``);
* ``"tag_L"``: tag 1 on the face x = 0 and tag 2 on x = L (None: no tags);
* ``"model"``: a model class of the package, built as ``cls(mesh, None,
  *args, dtype=, device=, **kwargs)``; an argument ``"@sincos"`` is
  ``sincos(mesh)``, a DG-0 coefficient of the cell midpoints;
* ``"dtype"``: ``"float32"`` or ``"float64"``; ``"dt"``: a step set after
  construction (the sponge's); ``"u0"``: ``(center, width, amplitude)``, an
  initial Gaussian pulse of u over the first ``len(center)`` axes (a plane
  pulse for a center of one coordinate; zero fields otherwise);
* ``"run"``: ``rk``, ``rk_record``, ``dirk``, ``dirk_record`` (the sharded
  solvers on the global model), ``streamed``/``streamed_dirk``
  (``build_sharded`` or ``build_sharded_grid``), ``streamed_nonzero`` (the
  streamed solver from a nonzero template state, which must be refused) or
  ``decompose`` (only the decomposition); ``"t_end"``; ``"points"`` and
  ``"bad_points"`` (sensors; the bad ones must be refused after the good
  run).

``run_cases(device, cases)`` runs them on one rank and returns, per case,
the global fields as float64 numpy (every rank holds them), the sensor
series and the sensors' nearest nodes (``locate_sensors``: rank and local
coordinates; lattice decompositions), this rank's DOF count, the CG counts
and dot weights,
this rank's K1 launches and seconds in the march (after the setup), the
message of an expected refusal (``ValueError``) and, for a case with
``"k1_operands": True``, the operands this rank's K1 gets (its local
lattice, degree and packed coefficients, on the host).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.bowl import create_bowl_box
from ..core.mesh import Mesh, _structured, as_unstructured, tag_boundaries
from ..models.experimental import LinearSpectralSponge
from ..models.linear import LinearSpectralExplicit, LinearSpectralImplicit
from ..models.lossy import LossySpectralExplicit, LossySpectralImplicit
from ..models.westervelt import WesterveltSpectralExplicit
from ..ops.stiffness import stiffness_apply
from .grid import (
    GridDecomposition,
    ShardedExplicitSolver2D,
    ShardedImplicitSolverND,
    build_sharded_grid,
)
from .slab import ShardedExplicitSolver, ShardedImplicitSolver, SlabDecomposition, build_sharded
from .unstructured import (
    ShardedUnstructuredExplicitSolver,
    ShardedUnstructuredImplicitSolver,
    UnstructuredDecomposition,
)

MODELS = {cls.__name__: cls for cls in (
    LinearSpectralExplicit, LinearSpectralImplicit, LossySpectralExplicit, LossySpectralImplicit,
    WesterveltSpectralExplicit, LinearSpectralSponge)}


def sincos(mesh) -> np.ndarray:
    """1 + 0.1 sin(3x) cos(2y) at the cell midpoints (a smooth heterogeneous
    wave speed that a streamed slab computes from its own cells)."""
    mids = mesh.cell_midpoints()
    return 1.0 + 0.1 * np.sin(3.0 * mids[:, 0]) * np.cos(2.0 * mids[:, 1])


def make_mesh(spec: dict):
    kind, *rest = spec["mesh"]
    if kind in ("interval", "rectangle", "box"):
        n, lo, hi = rest
        mesh = _structured(tuple(n), tuple(lo), tuple(hi))
    elif kind == "bowl":
        args, kwargs = rest
        mesh, _ = create_bowl_box(*args, **kwargs)
    elif kind == "deformed":
        n, lo, hi, seed, amp = rest
        base = _structured(tuple(n), tuple(lo), tuple(hi))
        verts = base.vertices.copy()
        vlo, vhi = verts.min(axis=0), verts.max(axis=0)
        inner = np.all((verts > vlo + 1e-12) & (verts < vhi - 1e-12), axis=1)
        rng = np.random.default_rng(seed)
        verts[inner] += amp * (rng.random((int(inner.sum()), verts.shape[1])) - 0.5)
        mesh = Mesh(dim=base.dim, vertices=verts, cells=base.cells, grid_shape=base.grid_shape)
    elif kind == "jittered":
        n, lo, hi, seed, amp, scramble = rest
        base = _structured(tuple(n), tuple(lo), tuple(hi))
        verts, cells = base.vertices.copy(), np.asarray(base.cells)
        vlo, vhi = verts.min(axis=0), verts.max(axis=0)
        inner = np.all((verts > vlo + 1e-12) & (verts < vhi - 1e-12), axis=1)
        rng = np.random.default_rng(seed)
        verts[inner] += amp * (rng.random((int(inner.sum()), verts.shape[1])) - 0.5)
        if scramble:
            perm = rng.permutation(base.num_vertices)
            moved = np.empty_like(verts)
            moved[perm] = verts
            verts, cells = moved, perm[cells]
        mesh = Mesh(dim=base.dim, vertices=verts, cells=cells)
    else:
        raise ValueError(f"unknown mesh kind {kind!r}")
    return as_unstructured(mesh) if spec.get("as_unstructured") else mesh


def tag(mesh, L):
    """Tag 1 on x = 0 and tag 2 on x = L."""
    if L is not None:
        tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    return mesh


def make_model(spec: dict, device, mesh=None):
    """The case's model on ``device`` (on ``mesh`` if given, else the case's
    mesh, tagged)."""
    if mesh is None:
        mesh = tag(make_mesh(spec), spec.get("tag_L"))
    args = [sincos(mesh) if isinstance(a, str) and a == "@sincos" else a for a in spec["args"]]
    model = MODELS[spec["model"]](mesh, None, *args, dtype=getattr(torch, spec["dtype"]),
                                  device=device, **spec.get("kwargs", {}))
    if "dt" in spec:
        model.dt = float(spec["dt"])
        model._build()
    model.init()
    if "u0" in spec:
        center, width, amp = spec["u0"]
        x = model.ops.dof_coords()[:, : len(center)]
        r2 = ((x - np.asarray(center)) ** 2).sum(axis=1)
        model.u_n = model.ops.to_device(amp * np.exp(-r2 / width**2))
    return model


def _host(t) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def _streamed(spec: dict, device, implicit: bool):
    kind, n, lo, hi = spec["mesh"]
    degree = spec["args"][0]

    def factory(local_mesh):
        return make_model(spec, device, tag(local_mesh, spec.get("tag_L")))

    dtype = getattr(torch, spec["dtype"])
    if spec.get("decomp") == "grid":
        return build_sharded_grid(factory, tuple(n), lo, hi, degree, tuple(spec["dshape"]), dtype,
                                  implicit=implicit, device=device)
    return build_sharded(factory, tuple(n), lo, hi, degree, None, dtype, implicit=implicit,
                         device=device)


def _solver(spec: dict, model, device, implicit: bool):
    """The case's sharded solver of ``model``."""
    decomp = spec.get("decomp", "slab")
    if decomp == "grid":
        cls = ShardedImplicitSolverND if implicit else ShardedExplicitSolver2D
        return cls(model, tuple(spec["dshape"]), device=device)
    if decomp == "unstructured":
        cls = ShardedUnstructuredImplicitSolver if implicit else ShardedUnstructuredExplicitSolver
        return cls(model, partition=spec.get("partition", "auto"), device=device)
    return (ShardedImplicitSolver if implicit else ShardedExplicitSolver)(model, device=device)


def _decompose(spec: dict, device):
    """The case's decomposition alone."""
    mesh, degree, dtype = make_mesh(spec), spec["args"][0], getattr(torch, spec["dtype"])
    decomp = spec.get("decomp", "slab")
    if decomp == "grid":
        return GridDecomposition(mesh, degree, tuple(spec["dshape"]), dtype, device)
    if decomp == "unstructured":
        return UnstructuredDecomposition(mesh, degree, None, dtype,
                                         partition=spec.get("partition", "auto"), device=device)
    return SlabDecomposition(mesh, degree, None, dtype, device)


def run_case(spec: dict, device) -> dict:
    """One case on this rank (see the module docstring)."""
    run, t_end = spec["run"], spec.get("t_end")
    out = {"name": spec["name"], "rank": torch.distributed.get_rank()}
    if run == "decompose":
        try:
            _decompose(spec, device)
            out["error"] = None
        except ValueError as e:
            out["error"] = str(e)
        return out
    if run == "streamed_nonzero":
        solver = _streamed(spec, device, implicit=False)
        solver.model.u_n = torch.ones_like(solver.model.u_n)
        try:
            solver.rk(0.0, t_end)
            out["error"] = None
        except ValueError as e:
            out["error"] = str(e)
        return out
    streamed = run in ("streamed", "streamed_dirk")
    if streamed:
        solver = _streamed(spec, device, implicit=run == "streamed_dirk")
        march = solver.dirk if run == "streamed_dirk" else solver.rk
    else:
        solver = _solver(spec, make_model(spec, device), device, implicit=run.startswith("dirk"))
        march = getattr(solver, run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # the march alone: its K1 launches and its time, after the setup
    launches, t0 = stiffness_apply.launches, time.perf_counter()
    if run.endswith("_record"):
        pts = np.asarray(spec["points"], np.float64)
        u, v, _, times, ys = march(0.0, t_end, pts)
        out.update(times=times, ys=_host(ys))
        if hasattr(solver.dec, "locate_sensors"):
            out["located"] = solver.dec.locate_sensors(pts)
    else:
        u, v, _ = march(0.0, t_end)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out.update(seconds=time.perf_counter() - t0, k1=stiffness_apply.launches - launches,
               local_ndofs=solver.dec.local_ndofs)
    if streamed:
        u, v = solver.global_result()
    out.update(u=_host(u), v=_host(v))
    if spec.get("k1_operands"):
        out["k1_operands"] = {
            "gdims": tuple(solver.dec.ops.gdims), "degree": solver.dec.ops.degree,
            "F": [{name: f.cpu() for name, f in solver.consts[k].items()}
                  for k in type(solver.model).STIFF_KEYS]}
    if solver.model.__dict__.get("cg_stats"):
        out["cg"] = solver.model.cg_stats["max_iterations"]
        out["cg_res2"] = solver.model.cg_stats["max_residual2"]
        out["weights"] = _host(solver.weights)
    if spec.get("bad_points") is not None:
        try:
            solver.rk_record(t_end, t_end + 2 * solver.model.dt,
                             np.asarray(spec["bad_points"], np.float64))
            out["bad_points_error"] = None
        except ValueError as e:
            out["bad_points_error"] = str(e)
    return out


def run_cases(device, cases) -> list:
    """Every case of ``cases`` on this rank, in order (the job that
    ``launch.spawn`` runs on each rank)."""
    return [run_case(spec, device) for spec in cases]


def run_single(spec: dict, device) -> dict:
    """The case's model on one device without the decomposition (its own
    ``rk``/``rk_record``/``dirk``/``dirk_record``); the same keys as
    ``run_case``."""
    model = make_model(spec, device)
    run = spec["run"].replace("streamed_dirk", "dirk").replace("streamed", "rk")
    out = {"name": spec["name"]}
    if run.endswith("_record"):
        u, v, _, times, ys = getattr(model, run)(0.0, spec["t_end"],
                                                  np.asarray(spec["points"], np.float64))
        out.update(times=times, ys=_host(ys))
    else:
        u, v, _ = getattr(model, run)(0.0, spec["t_end"])
    out.update(u=_host(u), v=_host(v))
    if model.__dict__.get("cg_stats"):
        out["cg"] = model.cg_stats["max_iterations"]
    return out
