"""Geometry precompute: scaled Jacobian factors for volume and facet terms.

Copied from ``fenicsxfus_tpu/core/geometry.py`` (numpy, no jax). Analogue of
the reference's geometry precompute
(``cpp/fenicsx-sf/common/precompute.hpp``):

* ``compute_scaled_jacobian_determinant`` (:34-94)  → ``volume_mass_factors``:
  per-cell, per-GLL-point  w_q * |det J|  (the diagonal mass entries in the
  reference frame),
* ``compute_scaled_geometrical_factor`` (:102-213) → ``volume_stiffness_factors``:
  per-cell, per-point symmetric  G = w_q * |det J| * J^{-1} J^{-T}  packed as
  1 (1D) / 3 (2D: 00,01,11) / 6 (3D: 00,01,02,11,12,22) entries,
* facet analogues for the tagged-boundary source/ABC terms (reference builds
  these through FFCx facet kernels, ``cpp/fenicsx-sf/common/Linear.hpp:101-124``).

All host numpy float64; results are shipped to device once.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .. import native
from ..analysis.timing import span
from . import geometry_chunks
from .geometry_chunks import chunk_factors
from .geometry_chunks import jacobians as _jacobians
from .gll import gll_points_weights_01

SYM_PAIRS = {
    1: [(0, 0)],
    2: [(0, 0), (0, 1), (1, 1)],
    3: [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)],
}


def _geom_tab_1d(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Linear geometry basis {1-x, x} values and derivatives at ``pts``."""
    phi = np.stack([1.0 - pts, pts], axis=-1)  # [n, 2]
    dphi = np.broadcast_to(np.array([-1.0, 1.0]), phi.shape).copy()
    return phi, dphi


def _geom_grad_tensor(pts_per_axis: list[np.ndarray]) -> np.ndarray:
    """dshape[q, v, b]: gradient of the 2**d multilinear shape functions at the
    tensor lattice of points; q and v tensor-lex (axis 0 slowest)."""
    d = len(pts_per_axis)
    tabs = [_geom_tab_1d(p) for p in pts_per_axis]
    nq = int(np.prod([len(p) for p in pts_per_axis]))
    out = np.zeros((nq, 2**d, d))
    for b in range(d):
        acc = np.ones((1, 1))
        for a in range(d):
            t = tabs[a][1] if a == b else tabs[a][0]  # [n_a, 2]
            acc = np.einsum("qv,nw->qnvw", acc, t).reshape(
                acc.shape[0] * t.shape[0], acc.shape[1] * 2
            )
        out[:, :, b] = acc
    return out


def volume_factors(mesh, N: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (wdetJ [Nc, N**d], G [Nc, N**d, nsym]) at the GLL lattice."""
    x1, w1 = gll_points_weights_01(N)
    return quadrature_factors(mesh, x1, w1)


# cells per chunk of ``quadrature_factors``: about 40 MB of fp64
# Jacobians at p = 4, whatever the mesh size
CHUNK_CELLS = 4096
# meshes of at least this many cells spread their chunks over worker
# processes, one per core up to 8 (a 157k-cell mesh takes about 30 s in one)
PARALLEL_CELLS = 20000


def _factors_in_workers(bounds, chunk_args, workers, wdetJ, G) -> int:
    """Fill ``wdetJ`` and ``G`` chunk by chunk in ``workers`` processes
    running ``geometry_chunks.py`` (numpy only: they neither fork the
    caller, which may hold CUDA and torch threads, nor import the package);
    chunk i goes to worker i mod ``workers``, one request at a time. Every
    worker has ended when this returns or raises. Returns the degenerate
    cells' count."""
    cmd = [sys.executable, str(Path(geometry_chunks.__file__))]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
    procs = []

    def run(k):
        proc, bad = procs[k], 0
        for c0, c1 in bounds[k::workers]:
            pickle.dump(chunk_args(c0, c1), proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
            proc.stdin.flush()
            try:
                wdetJ[c0:c1], G[c0:c1], n = pickle.load(proc.stdout)
            except EOFError:
                raise RuntimeError(f"geometry worker ended with exit code {proc.wait()}") from None
            bad += n
        return bad

    try:
        for _ in range(workers):
            procs.append(subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                          env=env))
        with ThreadPoolExecutor(workers) as pool:
            return sum(pool.map(run, range(workers)))
    except BaseException:
        for proc in procs:
            proc.kill()
        raise
    finally:
        # a worker ends when its input does
        for proc in procs:
            for f in (proc.stdin, proc.stdout):
                with contextlib.suppress(OSError):
                    f.close()
            proc.wait()


def quadrature_factors(
    mesh, x1: np.ndarray, w1: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Geometry factors at an arbitrary tensor-product quadrature rule
    (per-axis points ``x1`` / weights ``w1`` on [0,1]) — used by the
    non-collocated Gauss-quadrature operators (the reference's
    ``fenicsx-pc`` variant decouples quadrature from basis degree,
    ``cpp/fenicsx-pc/common/precompute_op.hpp``).

    From ``PARALLEL_CELLS`` cells on, as in the JAX package, the native
    library (``native/geometry.cpp``, built at first use; a failed build
    raises) streams the factors cell by cell over threads. Below that, or
    under ``FUS_NATIVE=0``, the per-cell arithmetic is the JAX package's
    numpy path; it runs over ``CHUNK_CELLS`` cells at a time, so [chunk,
    Nq, d, d] Jacobians, not [Nc, Nq, d, d], live on the host beside the
    results, and from ``PARALLEL_CELLS`` cells on the chunks are shared
    among worker processes (``_factors_in_workers``), one per core up to 8.
    Every cell's numpy factors are the same bits whatever the chunking.
    """
    d = mesh.dim
    # weights at the tensor lattice
    w = w1
    for _ in range(d - 1):
        w = np.multiply.outer(w, w1).reshape(-1)
    pairs = SYM_PAIRS[d]
    nc = mesh.num_cells
    if nc >= PARALLEL_CELLS and native.enabled():
        grids = np.meshgrid(*([x1] * d), indexing="ij")
        qpts = np.stack([g.reshape(-1) for g in grids], axis=-1)
        with span("fus.setup.library"):  # built and loaded at its first call
            native.library()
        wdetJ, G = native.volume_factors(mesh.cell_vertices(), qpts, w)
        # w > 0, so w·|det J| is 0 exactly where det J is (as the numpy
        # path, count the points)
        degenerate = int(np.count_nonzero(~(wdetJ > 0)))
        if degenerate:
            raise ValueError(f"{degenerate} degenerate cells (detJ == 0)")
        return wdetJ, G
    dshape = _geom_grad_tensor([x1] * d)  # [nq**d, 2**d, d]
    nq = dshape.shape[0]
    bounds = [(c0, min(c0 + CHUNK_CELLS, nc)) for c0 in range(0, nc, CHUNK_CELLS)]

    def chunk_args(c0, c1):
        return mesh.vertices[mesh.cells[c0:c1]], dshape, w, pairs

    workers = min(8, os.cpu_count() or 1, len(bounds)) if nc >= PARALLEL_CELLS else 1
    wdetJ = np.empty((nc, nq))
    G = np.empty((nc, nq, len(pairs)))
    if workers > 1:
        degenerate = _factors_in_workers(bounds, chunk_args, workers, wdetJ, G)
    else:
        degenerate = 0
        for c0, c1 in bounds:
            wdetJ[c0:c1], G[c0:c1], bad = chunk_factors(chunk_args(c0, c1))
            degenerate += bad
    # inverted-orientation cells are fine: |detJ| is used throughout
    if degenerate:
        raise ValueError(f"{degenerate} degenerate cells (detJ == 0)")
    return wdetJ, G


def is_uniform_mesh(mesh, rtol: float = 1e-12) -> bool:
    """True if every cell is the same axis-aligned translate (structured
    uniform grid) — enables the shared-element-matrix fast path."""
    if getattr(mesh, "uniform_hint", False):
        return True
    verts = mesh.cell_vertices()
    rel = verts - verts[:, :1, :]
    ref = rel[0]
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    return bool(np.all(np.abs(rel - ref[None]) <= rtol * scale))


def facet_factors(mesh, space, facets: np.ndarray):
    """Assembly data for a set of boundary facets.

    Parameters: ``facets`` [Nf, 2] of (cell, local_face).
    Returns (gdofs [Nf, Nfn] int32, wdetJf [Nf, Nfn], cells [Nf] int32) where
    Nfn = N**(d-1) facet GLL nodes; wdetJf = facet quadrature weight × surface
    measure at each facet node. For d==1 facets are points: Nfn=1, wdetJf=1.
    """
    d = mesh.dim
    N = space.N
    nf = len(facets)
    cells = facets[:, 0].astype(np.int32)
    if nf == 0:
        return (
            np.zeros((0, max(N ** (d - 1), 1)), np.int32),
            np.zeros((0, max(N ** (d - 1), 1))),
            cells,
        )
    nfn = N ** (d - 1) if d > 1 else 1
    gdofs = np.zeros((nf, nfn), dtype=np.int32)
    wdetJf = np.zeros((nf, nfn))
    x1, w1 = gll_points_weights_01(N)
    for face in range(2 * d):
        sel = np.where(facets[:, 1] == face)[0]
        if sel.size == 0:
            continue
        axis, side = divmod(face, 2)
        local = space.face_local_dofs(axis, side)  # [nfn]
        gdofs[sel] = space.dofmap_for_cells(facets[sel, 0])[:, local]
        if d == 1:
            wdetJf[sel] = 1.0
            continue
        # Facet lattice points: fix xi_axis = side, tensor over other axes.
        pts = [x1] * d
        pts[axis] = np.array([0.0 if side == 0 else 1.0])
        dshape = _geom_grad_tensor(pts)  # [nfn, 2**d, d]
        verts = mesh.cell_vertices()[facets[sel, 0]]
        J = _jacobians(verts, dshape)  # [nsel, nfn, d, d]
        tang = [a for a in range(d) if a != axis]
        Jf = J[:, :, :, tang]  # [nsel, nfn, d, d-1]
        JtJ = np.einsum("cqat,cqau->cqtu", Jf, Jf)
        meas = np.sqrt(np.abs(np.linalg.det(JtJ)))
        wf = w1
        for _ in range(d - 2):
            wf = np.multiply.outer(wf, w1).reshape(-1)
        wdetJf[sel] = wf[None, :] * meas
    return gdofs, wdetJf, cells
