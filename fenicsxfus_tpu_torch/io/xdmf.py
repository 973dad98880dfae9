"""XDMF/HDF5 mesh reading and field output (a copy of the JAX package's
``io/xdmf.py``, numpy on the host; no jax).

Reads the reference repo's example meshes (``mesh.xdmf`` + ``mesh.h5``,
written by DOLFINx ``XDMFFile``; reference read path
``linear_planewave2d_1_exp.py:43-49``): geometry, quad/hex topology, cell
tags and facet tags. Vertex ordering is converted from the DOLFINx
convention (x-fastest) to this framework's tensor-lex (axis-0 slowest) order.

Field output: the reference writes VTX/ADIOS2 ``.bp`` (not available here);
this module writes (a) ``.npz`` snapshots with DOF coordinates + values
(exact), and (b) ParaView-readable XDMF+HDF5 with the P1 (vertex)
restriction of the field. Fields may be torch tensors on any device: each
write copies a field to the host once.

``h5py`` is imported where the HDF5 files are read or written, as in the JAX
package: without it (the GPU machine has none) those paths raise
``ImportError``, and ``save_field_npz`` and inline XML data still work.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from ..core.mesh import Mesh, _face_local_vertices, boundary_facets

# XDMF/VTK (counter-clockwise ring) → tensor-lex (axis-0 slowest) local
# vertex permutation: my_cells[:, m] = xdmf_cells[:, _PERM[m]].
# VTK quad ring: (0,0),(1,0),(1,1),(0,1); hex: bottom ring then top ring.
_PERM = {
    2: np.array([0, 1]),
    4: np.array([0, 3, 1, 2]),
    8: np.array([0, 4, 3, 7, 1, 5, 2, 6]),
}

_XDMF_TOPO = {1: "Polyline", 2: "Quadrilateral", 3: "Hexahedron"}


def _host(u) -> np.ndarray:
    """A field as a host array: one device-to-host copy of a tensor."""
    if isinstance(u, torch.Tensor):
        return u.detach().cpu().numpy()
    return np.asarray(u)


def _read_dataitem(item, dirname):
    text = item.text.strip()
    if item.get("Format", "HDF") == "HDF":
        import h5py

        fname, path = text.split(":")
        with h5py.File(os.path.join(dirname, fname), "r") as f:
            return np.asarray(f[path])
    return np.fromstring(text, sep=" ")


def read_mesh(path: str, name: str | None = None) -> Mesh:
    """Read mesh + cell/facet tags from an XDMF file (DOLFINx layout)."""
    tree = ET.parse(path)
    dirname = os.path.dirname(os.path.abspath(path))
    domain = tree.getroot().find("Domain")
    grids = domain.findall("Grid")
    main = None
    for g in grids:
        gname = g.get("Name", "")
        if gname.endswith("_cells") or gname.endswith("_facets"):
            continue
        if name is None or gname == name:
            main = g
            break
    if main is None:
        raise ValueError(f"no mesh grid named {name!r} in {path}")
    mesh_name = main.get("Name")

    topo = main.find("Topology")
    geom = main.find("Geometry")
    cells = _read_dataitem(topo.find("DataItem"), dirname).astype(np.int64)
    verts = np.asarray(_read_dataitem(geom.find("DataItem"), dirname), np.float64)
    npe = cells.shape[1]
    dim = {2: 1, 4: 2, 8: 3}[npe]
    cells = cells[:, _PERM[npe]]
    mesh = Mesh(dim=dim, vertices=verts[:, :dim].copy(), cells=cells)

    # tags
    for g in grids:
        gname = g.get("Name", "")
        if gname == f"{mesh_name}_cells":
            vals = _read_dataitem(g.find("Attribute").find("DataItem"), dirname).reshape(-1)
            topo_c = _read_dataitem(g.find("Topology").find("DataItem"), dirname)
            mesh.cell_tags = _match_cell_values(mesh.cells, topo_c, vals)
        elif gname == f"{mesh_name}_facets":
            vals = _read_dataitem(g.find("Attribute").find("DataItem"), dirname).reshape(-1)
            topo_f = _read_dataitem(g.find("Topology").find("DataItem"),
                                    dirname).astype(np.int64)
            mesh.facet_tags = _match_facet_tags(mesh, topo_f, vals)
    return mesh


def _match_cell_values(cells, topo_c, vals):
    """Cell tag values may be listed in a different cell order — match by
    sorted vertex sets."""
    a = np.sort(cells, axis=1)
    b = np.sort(np.asarray(topo_c, np.int64), axis=1)
    if a.shape == b.shape and np.array_equal(a, b):
        return np.asarray(vals).astype(np.int64)
    # general matching via lexicographic ranks
    oa = np.lexsort(a.T[::-1])
    ob = np.lexsort(b.T[::-1])
    if not np.array_equal(a[oa], b[ob]):
        raise ValueError("cell tag topology mismatch")
    out = np.zeros(len(cells), np.int64)
    out[oa] = np.asarray(vals, np.int64)[ob]
    return out


def _match_facet_tags(mesh, topo_f, vals):
    """Tagged facet vertex lists → {tag: [(cell, local_face)]}."""
    bf = boundary_facets(mesh)  # [Nbf, 2]
    d = mesh.dim
    keys = np.zeros((len(bf), 2 ** (d - 1)), np.int64)
    for face in range(2 * d):
        sel = bf[:, 1] == face
        if not sel.any():
            continue
        axis, side = divmod(face, 2)
        locs = _face_local_vertices(d, axis, side)
        keys[sel] = np.sort(mesh.cells[bf[sel, 0]][:, locs], axis=1)
    order = np.lexsort(keys.T[::-1])
    skeys = keys[order]
    fkeys = np.sort(topo_f, axis=1)
    idx = _searchsorted_rows(skeys, fkeys)
    found = idx >= 0
    tags = {}
    vals = np.asarray(vals, np.int64)
    for t in np.unique(vals[found]):
        sel = found & (vals == t)
        tags[int(t)] = bf[order[idx[sel]]]
    return tags


def _searchsorted_rows(sorted_rows: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Index of each query row in lexicographically sorted rows (−1 if absent),
    via structured-dtype views (binary search on whole rows)."""
    n = len(sorted_rows)
    a = np.ascontiguousarray(sorted_rows).view(
        [("", sorted_rows.dtype)] * sorted_rows.shape[1]).reshape(-1)
    q = np.ascontiguousarray(query).view([("", query.dtype)] * query.shape[1]).reshape(-1)
    idx = np.searchsorted(a, q)
    idx_c = np.clip(idx, 0, n - 1)
    match = a[idx_c] == q
    return np.where(match, idx_c, -1)


# ---------------------------------------------------------------- output


def save_field_npz(path: str, ops, fields: dict, t: float = 0.0):
    """Exact snapshot: DOF coordinates + nodal values (+ time)."""
    data = {k: _host(v) for k, v in fields.items()}
    np.savez_compressed(path, coords=ops.space.dof_coords, t=t, **data)


def _xdmf_cells(mesh) -> np.ndarray:
    """The mesh's cells in the DOLFINx/XDMF vertex order."""
    cells_x = np.empty_like(mesh.cells)
    cells_x[:, _PERM[2**mesh.dim]] = mesh.cells
    return cells_x


def write_xdmf_field(path: str, ops, u, name: str = "u"):
    """ParaView-readable P1 restriction of a nodal field (vertex values)."""
    import h5py

    mesh = ops.mesh
    base = os.path.splitext(path)[0]
    h5path = base + ".h5"
    # vertex DOF values: vertices are the corner GLL nodes of each cell
    vvals = _vertex_values(ops, u)
    with h5py.File(h5path, "w") as f:
        f["/mesh/geometry"] = mesh.vertices
        f["/mesh/topology"] = _xdmf_cells(mesh)
        f[f"/fields/{name}"] = vvals
    nv, dim = mesh.vertices.shape
    nc, npe = mesh.cells.shape
    geom_type = {1: "X", 2: "XY", 3: "XYZ"}[dim]
    h5name = os.path.basename(h5path)
    xml = f"""<?xml version="1.0"?>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Topology TopologyType="{_XDMF_TOPO[dim]}" NumberOfElements="{nc}" NodesPerElement="{npe}">
        <DataItem Dimensions="{nc} {npe}" NumberType="Int" Format="HDF">{h5name}:/mesh/topology</DataItem>
      </Topology>
      <Geometry GeometryType="{geom_type}">
        <DataItem Dimensions="{nv} {dim}" Format="HDF">{h5name}:/mesh/geometry</DataItem>
      </Geometry>
      <Attribute Name="{name}" AttributeType="Scalar" Center="Node">
        <DataItem Dimensions="{nv} 1" Format="HDF">{h5name}:/fields/{name}</DataItem>
      </Attribute>
    </Grid>
  </Domain>
</Xdmf>
"""
    with open(base + ".xdmf", "w") as f:
        f.write(xml)


class XDMFTimeSeriesWriter:
    """Time-series field movie (the reference's VTX/ADIOS2 ``.bp`` analogue,
    ``linear_planewave2d_1_exp.py:129-133``): one HDF5 file accumulating P1
    snapshots plus an XDMF temporal collection ParaView can animate.

    Usage::

        with XDMFTimeSeriesWriter("movie.xdmf", model.ops) as w:
            w.write(model.u_n, 0.0)
            ...
    """

    def __init__(self, path: str, ops, name: str = "u"):
        import h5py

        self.ops = ops
        self.name = name
        self.base = os.path.splitext(path)[0]
        self.h5path = self.base + ".h5"
        self.times: list[float] = []
        mesh = ops.mesh
        self._h5 = h5py.File(self.h5path, "w")
        self._h5["/mesh/geometry"] = mesh.vertices
        self._h5["/mesh/topology"] = _xdmf_cells(mesh)

    def write(self, u, t: float):
        idx = len(self.times)
        self._h5[f"/fields/{self.name}/{idx}"] = _vertex_values(self.ops, u)
        self.times.append(float(t))

    def close(self):
        mesh = self.ops.mesh
        nv, dim = mesh.vertices.shape
        nc, npe = mesh.cells.shape
        geom_type = {1: "X", 2: "XY", 3: "XYZ"}[dim]
        h5name = os.path.basename(self.h5path)
        frames = []
        for i, t in enumerate(self.times):
            frames.append(f"""      <Grid Name="t{i}" GridType="Uniform">
        <xi:include xpointer="xpointer(//Grid[@Name='mesh_ref']/*)"/>
        <Time Value="{t!r}"/>
        <Attribute Name="{self.name}" AttributeType="Scalar" Center="Node">
          <DataItem Dimensions="{nv} 1" Format="HDF">{h5name}:/fields/{self.name}/{i}</DataItem>
        </Attribute>
      </Grid>""")
        xml = f"""<?xml version="1.0"?>
<Xdmf Version="3.0" xmlns:xi="http://www.w3.org/2001/XInclude">
  <Domain>
    <Grid Name="mesh_ref" GridType="Uniform">
      <Topology TopologyType="{_XDMF_TOPO[dim]}" NumberOfElements="{nc}" NodesPerElement="{npe}">
        <DataItem Dimensions="{nc} {npe}" NumberType="Int" Format="HDF">{h5name}:/mesh/topology</DataItem>
      </Topology>
      <Geometry GeometryType="{geom_type}">
        <DataItem Dimensions="{nv} {dim}" Format="HDF">{h5name}:/mesh/geometry</DataItem>
      </Geometry>
    </Grid>
    <Grid Name="series" GridType="Collection" CollectionType="Temporal">
{os.linesep.join(frames)}
    </Grid>
  </Domain>
</Xdmf>
"""
        with open(self.base + ".xdmf", "w") as f:
            f.write(xml)
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def write_movie(model, t0: float, tf: float, path: str, n_frames: int = 20, name: str = "u"):
    """Time-march ``model`` from t0 to tf writing ``n_frames`` equally spaced
    field snapshots — the reference's per-step ``VTXWriter.write`` loop
    (``linear_planewave2d_1_exp.py:129-133``) at a chosen frame rate.
    Returns the frame times."""
    w = XDMFTimeSeriesWriter(path, model.ops, name)
    try:
        w.write(model.u_n, t0)
        bounds = np.linspace(t0, tf, n_frames + 1)
        t = t0
        for tn in bounds[1:]:
            model.rk(t, float(tn))
            t = model.t
            w.write(model.u_n, t)
    finally:
        w.close()
    return np.asarray(w.times)


def _vertex_values(ops, u) -> np.ndarray:
    """Restrict a nodal GLL field (array or tensor on any device) to mesh
    vertices: [Nv], float64."""
    mesh, N, d = ops.mesh, ops.N, ops.d
    corners_local = []
    lattice = np.arange(N**d).reshape((N,) * d)
    for local in range(2**d):
        idx = tuple((N - 1) if (local >> (d - 1 - a)) & 1 else 0 for a in range(d))
        corners_local.append(lattice[idx])
    corner_dofs = ops.space.dofmap_for_cells(np.arange(mesh.num_cells))[:, corners_local]
    out = np.zeros(mesh.num_vertices)
    out[mesh.cells.reshape(-1)] = _host(u).reshape(-1)[corner_dofs.reshape(-1)]
    return out
