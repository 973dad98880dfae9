"""The general (per-cell) operator path, part by part, against the lattice
path at the same size: the port of ``benchmarks/unstructured_speed.py``.

The reference's production benchmarks read unstructured meshes; the port
solves them by gather → per-cell stiffness → deterministic fold
(``ops/operators.py``, torch ops: the JAX package runs this path in XLA).
On the distorted unit box (a smooth sine warp of amplitude 0.05 that keeps
the elements' quality; with ``shuffle`` its cell order and vertex ids
permuted by ``default_rng(7)``, with ``reorder`` then ``reorder_locality``),
at nx cells a side and degree p (the default nx = 28, p = 4: 113³ =
1,442,897 DOF), fp32, with a DG-0 coefficient 0.5 + U(0, 1) per cell:

  gather          x[dofmap]                       [Nc, N³]
  contract        the default cell route (``_stiffness_cells``: the dense
                  tabulation, ``stiffness_cells_dense``)
  sum-factorised  ``stiffness_cells``
  dense           ``stiffness_cells_dense``
  fold            the deterministic fold ``scatter`` (where the JAX script
                  times its blocked scatter, which the port does not have)
  apply           the whole ``stiffness_apply``
  lattice         K1 on ``create_box((nx,)*3)`` at the same degree, and the
                  apply's per-DOF time over K1's

and with ``with_segsum`` the oracle's parts: the sorted segment sum
(``scatter_segsum``), the padded-CSR fold (``build_csr_plan``: each DOF's
cell values gathered by ``index_select`` from an [ndofs, K] table), and the
oracle apply ``stiffness_apply_generic``. Before anything is timed, the two
cell routes are held together, the fold against the segment sum and the
CSR fold, and the apply against the oracle (``held``, max rel diff). Each
row is a CUDA-event median and the device's time alone
(``tools/variants.py::card_ms``) beside its bound
(``tools/bounds.py::general_bounds``).

    python -m fenicsxfus_tpu_torch.tools.unstructured_speed [--nx 28] [--degree 4]
        [--shuffle] [--reorder] [--with_segsum]

On the CPU (``--device cpu``) the same parts run and nothing is timed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.mesh import Mesh, create_box, reorder_locality
from ..ops.operators import SEMOperators, stiffness_cells, stiffness_cells_dense
from ..scripts import cli, device_dtype
from .bounds import floor_ms, general_bounds, nbytes, stencil_flops
from .phase_breakdown import rel
from .variants import card_ms


def build_csr_plan(dofmap: np.ndarray, ndofs: int):
    """The padded-CSR transpose of the fold: ``inv`` [ndofs, K] int32, each
    DOF's positions in the flattened cell values, padded with the index of
    one zero slot past their end; returns (inv, K)."""
    flat = dofmap.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_dofs = flat[order]
    counts = np.bincount(sorted_dofs, minlength=ndofs)
    K = int(counts.max())
    starts = np.zeros(ndofs + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pad_slot = flat.size
    inv = np.full((ndofs, K), pad_slot, np.int32)
    for k in range(K):
        sel = counts > k
        inv[sel, k] = order[starts[:-1][sel] + k]
    return inv, K


def distorted_box(nx: int, shuffle: bool = False, reorder: bool = False) -> Mesh:
    """The unit box warped by x_a += 0.05 sin(π x_b) sin(π x_c) (each axis
    by the other two), as the JAX script builds it; ``shuffle`` permutes
    its vertex ids and cell order (``default_rng(7)``), ``reorder`` then
    applies ``reorder_locality``."""
    base = create_box((nx, nx, nx), (0, 0, 0), (1.0, 1.0, 1.0))
    v = base.vertices.copy()
    w = 0.05
    v[:, 0] += w * np.sin(np.pi * v[:, 1]) * np.sin(np.pi * v[:, 2])
    v[:, 1] += w * np.sin(np.pi * v[:, 2]) * np.sin(np.pi * v[:, 0])
    v[:, 2] += w * np.sin(np.pi * v[:, 0]) * np.sin(np.pi * v[:, 1])
    cells = base.cells
    if shuffle:
        rng = np.random.default_rng(7)
        vperm = rng.permutation(base.num_vertices)
        v2 = np.empty_like(v)
        v2[vperm] = v
        v, cells = v2, vperm[cells][rng.permutation(base.num_cells)]
    mesh = Mesh(dim=3, vertices=v, cells=cells)
    return reorder_locality(mesh) if reorder else mesh


def main(nx: int = 28, degree: int = 4, with_segsum: bool = False, shuffle: bool = False,
         reorder: bool = False, dtype=None, device="cuda") -> dict:
    """The rows by name (ms None on the CPU), ``held`` and the per-DOF
    ratio of the apply over K1 (None on the CPU)."""
    dev, dtype = device_dtype(device, dtype, cpu_dtype=torch.float32)
    print(f"numbering: shuffle={shuffle} reorder={reorder}")
    mesh = distorted_box(nx, shuffle, reorder)
    ops = SEMOperators(mesh, degree, dtype=dtype, device=dev)
    if ops.lattice is not None or ops.uniform:
        raise RuntimeError("the distorted box took the lattice path")
    n, nc = ops.ndofs, mesh.num_cells
    print(f"distorted box: {nc} cells, p={degree}, {n / 1e6:.2f}M DOF, {dtype}")

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
    coeff = ops.stiff_coeff(0.5 + rng.random(nc))
    z0 = torch.as_tensor(rng.standard_normal((nc,) + (degree + 1,) * 3), dtype=dtype,
                         device=dev)
    inv, K = build_csr_plan(ops.space.dofmap, n)
    inv_t = torch.as_tensor(inv.reshape(-1), dtype=torch.int32, device=dev)

    def fold_csr(yc):
        padded = torch.cat([yc.reshape(-1), yc.new_zeros(1)])
        return padded.index_select(0, inv_t).view(n, K).sum(1)

    def contract_sf(z):
        return stiffness_cells(ops.D, ops.G, z, 3)

    def contract_de(z):
        return stiffness_cells_dense(ops.B_tab, ops.G, z, 3)

    fold = ops.scatter(z0)
    y = ops.stiffness_apply([x], [coeff])
    held = {"dense vs sum-factorised": rel(contract_de(z0), contract_sf(z0)),
            "fold vs segment sum": rel(fold, ops.scatter_segsum(z0)),
            "csr vs fold": rel(fold_csr(z0), fold),
            "apply vs stiffness_apply_generic": rel(y, ops.stiffness_apply_generic([x], [coeff]))}
    for k, v in held.items():
        print(f"  held: {k}: max rel diff {v:.3e}")
    del y, fold

    b = general_bounds(ops)
    parts = {"gather": (lambda: ops.gather(x), b["gather"]),
             "contract": (lambda: ops._stiffness_cells(z0),
                          b["dense" if ops._use_dense_tab() else "sum-factorised"]),
             "sum-factorised": (lambda: contract_sf(z0), b["sum-factorised"]),
             "dense": (lambda: contract_de(z0), b["dense"]),
             "fold": (lambda: ops.scatter(z0), b["scatter"]),
             "apply": (lambda: ops.stiffness_apply([x], [coeff]), b["apply"])}
    if with_segsum:
        f = z0.element_size()
        parts.update({
            "segment sum": (lambda: ops.scatter_segsum(z0), b["scatter_segsum"]),
            "csr fold": (lambda: fold_csr(z0),
                         floor_ms(f * z0.numel() + 4 * n * K, f * n, n * K)),
            "apply (oracle)": (lambda: ops.stiffness_apply_generic([x], [coeff]), b["apply"])})
    rows = {}
    for name, (fn, bound) in parts.items():
        rows[name] = {**card_ms(fn, dev), **bound}

    # the lattice path at the same size
    lops = SEMOperators(create_box((nx, nx, nx), (0, 0, 0), (1.0, 1.0, 1.0)), degree,
                        dtype=dtype, device=dev)
    xl = torch.as_tensor(rng.standard_normal(lops.ndofs), dtype=dtype, device=dev)
    cl = lops.stiff_coeff(1.0)
    rows["lattice"] = {**card_ms(lambda: lops.stiffness_apply([xl], [cl]), dev),
                       **floor_ms(nbytes(xl, cl), nbytes(xl),
                                  stencil_flops(lops.gdims, degree, 1, (0, 1, 2)))}
    for name, r in rows.items():
        r["share"] = None if r["ms"] is None else r["bound_ms"] / r["ms"]
        ms = "not measured" if r["ms"] is None else (
            f"{r['ms']:8.3f} ms ({n / r['ms'] / 1e6:6.2f} GDOF/s), device alone "
            f"{r['device_ms']:.3f} ms, share {r['share']:.3f}")
        print(f"  {name:<16} {ms}, bound {r['bound_ms']:.3f} ms ({r['bound_by']})"
              + (f" [K={K}]" if name == "csr fold" else ""))
    ratio = None
    if rows["lattice"]["ms"] is not None:
        ratio = rows["apply"]["ms"] / rows["lattice"]["ms"] * lops.ndofs / n
        print(f"  apply / lattice (K1) per-DOF ratio {ratio:.2f}x")
    return {"ndofs": n, "num_cells": nc, "lattice_ndofs": lops.ndofs, "K": K, "rows": rows,
            "held": held, "ratio": ratio}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
