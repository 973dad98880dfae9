"""Structured hexahedral meshes for the plain reference (numpy only).

A mesh is a lattice of n0 x n1 x n2 trilinear cells whose vertices may be
moved (the bowl-fitted box): vertices [(n0+1)(n1+1)(n2+1), 3] in lattice
order, axis 0 slowest; cells [Nc, 8] with the local vertex order
tensor-lexicographic, axis 0 slowest. A boundary facet is (cell, local
face) with local face 2*axis + side, the facet {xi_axis == side}.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Mesh:
    dim: int
    vertices: np.ndarray
    cells: np.ndarray
    facet_tags: dict = field(default_factory=dict)
    grid_shape: tuple | None = None
    uniform_hint: bool = False
    blend_layers: int = 0
    uniform_box: tuple | None = None


def _structured(n, lo, hi) -> Mesh:
    """The uniform box [lo, hi] cut into n[0] x n[1] x n[2] cells."""
    n = tuple(int(a) for a in n)
    axes = [np.linspace(lo[a], hi[a], n[a] + 1) for a in range(3)]
    X = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    vd = tuple(a + 1 for a in n)
    c = np.stack(np.meshgrid(*[np.arange(a) for a in n], indexing="ij"), axis=-1).reshape(-1, 3)
    cells = np.empty((len(c), 8), np.int64)
    for loc in range(8):
        off = [(loc >> (2 - a)) & 1 for a in range(3)]
        cells[:, loc] = np.ravel_multi_index([c[:, a] + off[a] for a in range(3)], vd)
    return Mesh(dim=3, vertices=X, cells=cells, grid_shape=n, uniform_hint=True)


def create_box(n, lo, hi) -> Mesh:
    return _structured(n, lo, hi)


def face_vertices(axis: int, side: int) -> np.ndarray:
    """Local vertex numbers of the facet {xi_axis == side}."""
    return np.array([v for v in range(8) if ((v >> (2 - axis)) & 1) == side])


def boundary_facets(mesh: Mesh) -> np.ndarray:
    """Every exterior facet of the lattice, [Nf, 2] of (cell, local face)."""
    n = mesh.grid_shape
    out = []
    for axis in range(3):
        for side in (0, 1):
            idx = [np.arange(a) for a in n]
            idx[axis] = np.array([0 if side == 0 else n[axis] - 1])
            g = np.meshgrid(*idx, indexing="ij")
            cells = np.ravel_multi_index([x.reshape(-1) for x in g], n)
            out.append(np.stack([cells, np.full(cells.shape, 2 * axis + side)], axis=1))
    return np.concatenate(out).astype(np.int64)


def facet_midpoints(mesh: Mesh, facets: np.ndarray) -> np.ndarray:
    """The mean of each facet's four vertices, [Nf, 3]."""
    out = np.empty((len(facets), 3))
    for face in range(6):
        sel = facets[:, 1] == face
        if sel.any():
            loc = face_vertices(*divmod(face, 2))
            out[sel] = mesh.vertices[mesh.cells[facets[sel, 0]][:, loc]].mean(axis=1)
    return out


def tag_boundaries(mesh: Mesh, tags: dict, default=None) -> Mesh:
    """Tag exterior facets by predicates on their midpoints (the first tag
    that matches wins); the rest get ``default`` or stay untagged."""
    facets = boundary_facets(mesh)
    mids = facet_midpoints(mesh, facets)
    assigned = np.full(len(facets), -1, np.int64)
    for tag, pred in tags.items():
        hit = np.asarray(pred(mids.T)) & (assigned == -1)
        assigned[hit] = tag
    if default is not None:
        assigned[assigned == -1] = default
    mesh.facet_tags = {int(t): facets[assigned == t] for t in np.unique(assigned) if t >= 0}
    return mesh
