"""An independent look at the reference's mesh: its volume and the area of
its source facets against the analytic domain and cap, so that a fault of
the mesher (which the reference holds as a frozen copy of the program's)
does not pass because both sides share it.

* ``mesh_volume_gap``: |sum of the cells' volumes - V| / V, with V the box
  L x W x W plus, on the bowl-fitted box, the spherical segment that the
  cap adds behind the rim plane, pi s^2 (3R - s) / 3 for the sagitta s.
  A trilinear cell's |det J| has degree 2 in each reference coordinate, so
  three GLL points an axis integrate it exactly.
* ``cap_area_gap``: |area of the source facets - A| / A, with A the
  cap's 2 pi R s (``bowl_cap_area``), the facets' |J_0 x J_1| integrated
  by ``FACE_POINTS`` GLL points an axis.

Both gaps are O(h^2) on a sound mesh (the cap's vertices lie on the
sphere and its rim on an inscribed polygon of the aperture circle).
"""

from __future__ import annotations

import math

import numpy as np

from .bowl_mesh import bowl_cap_area
from .sem import gll, q1_shape, tensor_points

FACE_POINTS = 6


def mesh_volume(mesh) -> float:
    """The volume of the mesh's trilinear cells, exact."""
    x1, w1 = gll(3)
    _, grad = q1_shape(tensor_points(x1))
    w = np.einsum("i,j,k->ijk", w1, w1, w1).reshape(-1)
    V = mesh.vertices[mesh.cells]
    total = 0.0
    for c0 in range(0, len(V), 65536):
        J = np.einsum("cva,qvb->cqab", V[c0:c0 + 65536], grad)
        total += float(np.sum(np.abs(np.linalg.det(J)) * w[None, :]))
    return total


def facets_area(mesh, facets: np.ndarray) -> float:
    """The area of the boundary ``facets`` [Nf, 2] (cell, local face
    2 * axis + side) of the mesh's trilinear cells."""
    x1, w1 = gll(FACE_POINTS)
    total = 0.0
    for face in range(6):
        sel = facets[facets[:, 1] == face, 0]
        if not len(sel):
            continue
        axis, side = divmod(face, 2)
        tang = [a for a in range(3) if a != axis]
        g0, g1 = np.meshgrid(x1, x1, indexing="ij")
        xi = np.zeros((FACE_POINTS**2, 3))
        xi[:, axis] = float(side)
        xi[:, tang[0]], xi[:, tang[1]] = g0.reshape(-1), g1.reshape(-1)
        _, grad = q1_shape(xi)
        J = np.einsum("cva,qvb->cqab", mesh.vertices[mesh.cells[sel]], grad)
        n = np.cross(J[..., :, tang[0]], J[..., :, tang[1]])
        total += float(np.sum(np.linalg.norm(n, axis=-1) * np.outer(w1, w1).reshape(-1)[None, :]))
    return total


def bowl_readings(mesh, L: float, W: float, R: float, a: float) -> dict:
    """``mesh_volume_gap`` and ``cap_area_gap`` of a bowl-fitted box whose
    source facets carry the tag 1."""
    sag = R - math.sqrt(R * R - a * a)
    volume = L * W * W + math.pi * sag * sag * (3.0 * R - sag) / 3.0
    area = bowl_cap_area(R, a)
    return {"mesh_volume_gap": abs(mesh_volume(mesh) - volume) / volume,
            "cap_area_gap": float(abs(facets_area(mesh, mesh.facet_tags[1]) - area) / area)}
