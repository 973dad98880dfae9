"""The spectral radius of each cell of the bowl mesh's deformation band: the
port of ``benchmarks/bowl_spectrum.py``.

The bowl-fitted run steps more often than the flat aperture because of the
stability clamp of its skewed blend cells. Which cells set λ_max? The
cell-local operators diag(m_c)⁻¹ K_c are decoupled, so one batched power
iteration (``percell_lambda``: 60 normalised applies of the port's
``stiffness_cells`` a cell, fp64 on the device) finds each band cell's
λ_max, with m_c the globally assembled lumped mass sliced at the cell's
nodes (the cell-local mass overstates sliver cells whose nodes carry their
neighbours' mass). Each band cell's λ over a uniform cell's (the last cell
of the mesh, beyond the band) is reported as max, p99 and median, the dt
clamp it implies (the square root of the largest), and per x-layer of the
band its max, p99 and the lateral radius of its worst cell.

On ``create_bowl_box`` of transducer ``tx`` (``drivers/hitu.py::
TRANSDUCERS``; default H101 at nx = 64, (64, 37, 37) cells) with blend =
``FUS_BOWL_BLEND_MULT`` (default 2) sags and hold = ``FUS_BOWL_HOLD_MULT``
(default 0.25) blends, as the JAX script reads them. The geometry factors
of the band and of the uniform cell come from ``core/geometry.py::
volume_factors``; the global mass is assembled in chunks of 32,768 cells
(each chunk's factors by ``volume_factors``: the native library from
20,000 cells, as in the JAX script) in float64 on the host.

    python -m fenicsxfus_tpu_torch.tools.bowl_spectrum [--nx 64] [--tx H101] [--degree 4]

On the CPU (``--device cpu``) the power iteration runs there.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..core.bowl import create_bowl_box
from ..core.geometry import volume_factors
from ..core.gll import diff_matrix
from ..core.mesh import Mesh
from ..core.space import build_space
from ..drivers.hitu import TRANSDUCERS
from ..ops.operators import stiffness_cells
from ..scripts import cli
from ..utils import resolve_device

CHUNK = 32768  # cells a chunk of the global mass


def percell_lambda(G_np, wdetJ_np, D, d: int = 3, iters: int = 60, seed: int = 0, mass=None,
                   device="cuda") -> np.ndarray:
    """Batched power iteration of diag(m_c)⁻¹ K_c, one cell a row, fp64 on
    ``device``: G_np [nb, Nq, nsym] (or [nb, N, ..., N, nsym]) geometry factors, wdetJ_np [nb, Nq]
    quadrature weights (collocated GLL: Nq = N^d), D [N, N] the 1D
    differentiation matrix; ``mass`` [nb, Nq] replaces the cell-local
    lumped mass. The start vectors from ``numpy.random.default_rng(seed)``.
    Returns λ [nb] (the last iteration's norm ratio)."""
    dev = resolve_device(device)
    nb, nq = wdetJ_np.shape
    N = D.shape[0]
    m = torch.as_tensor(np.maximum(wdetJ_np if mass is None else mass, 1e-300), device=dev)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((nb, nq))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    Dt = torch.as_tensor(np.asarray(D, np.float64), device=dev)
    G = np.asarray(G_np, np.float64).reshape(nb, nq, -1)
    Gt = torch.as_tensor(np.moveaxis(G, -1, 0).reshape((G.shape[-1], nb) + (N,) * d),
                         device=dev)
    zt = torch.as_tensor(z, device=dev)
    lam = None
    for _ in range(iters):
        w = stiffness_cells(Dt, Gt, zt.view((nb,) + (N,) * d), d).reshape(nb, nq) / m
        nw = torch.linalg.vector_norm(w, dim=1)
        lam = nw / torch.linalg.vector_norm(zt, dim=1)
        zt = w / nw[:, None]
    return lam.cpu().numpy()


def main(nx: int = 64, tx: str = "H101", degree: int = 4, device="cuda") -> dict:
    """λ of every band cell over the uniform cell's (``rel``), the summary
    and the per-layer table."""
    dev = resolve_device(device)
    g = TRANSDUCERS[tx]
    L, W = g["L"], g["W"]
    h = L / nx
    nyz = max(int(round(W / h)), 2)
    sag = g["roc"] - np.sqrt(g["roc"] ** 2 - g["a"] ** 2)
    bm = float(os.environ.get("FUS_BOWL_BLEND_MULT", "2.0"))
    hm = float(os.environ.get("FUS_BOWL_HOLD_MULT", "0.25"))
    blend = bm * sag
    t0 = time.perf_counter()
    mesh, _ = create_bowl_box((nx, nyz, nyz), (0, -W / 2, -W / 2), (L, W / 2, W / 2), g["roc"],
                              g["a"], blend=blend, lateral_hold=hm * blend)
    secs = {"create_bowl_box": time.perf_counter() - t0}
    bl = int(mesh.blend_layers)
    nb = bl * nyz * nyz
    nc = mesh.num_cells
    print(f"{tx} nx={nx} p={degree}: {nc} cells, blend_layers={bl} -> band {nb} cells "
          f"({nb / nc * 100:.1f}%), sag={sag * 1e3:.2f}mm blend={blend * 1e3:.2f}mm")
    N = degree + 1
    D = diff_matrix(N)

    def sub(cells):
        return Mesh(dim=3, vertices=mesh.vertices, cells=mesh.cells[cells])

    t0 = time.perf_counter()
    sel = np.concatenate([np.arange(nb), [nc - 1]])
    wdetJ_all, G_all = volume_factors(sub(sel), N)
    secs["band factors"] = time.perf_counter() - t0

    # the global assembled mass (coefficient 1), sliced at each band cell's nodes
    t0 = time.perf_counter()
    space = build_space(mesh, degree)
    m_glob = np.zeros(space.ndofs)
    for s in range(0, nc, CHUNK):
        e = min(s + CHUNK, nc)
        dmap = np.asarray(space.dofmap_for_cells(np.arange(s, e)))
        wd, _ = volume_factors(sub(slice(s, e)), N)
        np.add.at(m_glob, dmap.reshape(-1), wd.reshape(-1))
    mass_band = m_glob[np.asarray(space.dofmap_for_cells(np.arange(nb)))]
    secs["global mass"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lam_band = percell_lambda(G_all[:nb], wdetJ_all[:nb], D, mass=mass_band, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs["power iteration"] = time.perf_counter() - t0
    dof_u = np.asarray(space.dofmap_for_cells(np.array([nc - 1])))
    lam_u = float(percell_lambda(G_all[-1:], wdetJ_all[-1:], D, mass=m_glob[dof_u],
                                 device=dev)[0])
    print("host and device s: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f" ({dev})")

    rel = lam_band / lam_u
    summary = {"max": float(rel.max()), "p99": float(np.percentile(rel, 99)),
               "median": float(np.median(rel)), "clamp": float(np.sqrt(rel.max()))}
    print(f"uniform-cell lambda {lam_u:.4e}; band lambda/uniform: max {summary['max']:.3f}  "
          f"p99 {summary['p99']:.3f}  median {summary['median']:.3f}")
    print(f"implied dt clamp (sqrt of lambda ratio): {summary['clamp']:.3f}x")
    r3 = rel.reshape(bl, nyz, nyz)
    ys = (np.arange(nyz) + 0.5) * h - W / 2
    rr = np.sqrt(ys[:, None] ** 2 + ys[None, :] ** 2)
    layers = []
    print("\nper-x-layer: max and p99 of lambda/uniform, radius of worst cell")
    for ix in range(bl):
        sl = r3[ix]
        j = np.unravel_index(np.argmax(sl), sl.shape)
        layers.append({"layer": ix, "max": float(sl.max()), "p99": float(np.percentile(sl, 99)),
                       "r_worst": float(rr[j])})
        print(f"  layer {ix:2d}: max {sl.max():7.3f}  p99 {np.percentile(sl, 99):7.3f}  at "
              f"r={rr[j] * 1e3:5.1f} mm (aperture a={g['a'] * 1e3:.1f} mm)")
    return {"tx": tx, "nx": nx, "num_cells": nc, "band_cells": nb, "blend_layers": bl,
            "lam_uniform": lam_u, "rel": rel, "summary": summary, "layers": layers,
            "seconds": secs}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
