"""The port's XDMF/HDF5 I/O (``fenicsxfus_tpu_torch/io/xdmf.py``) against the
JAX package's (``fenicsxfus_tpu/io/xdmf.py``): DOLFINx-layout quad and hex
files written here with h5py (cells, vertices, cell tags and facet tags in
shuffled orders) read by both packages to the same mesh, and the writers'
XML and datasets equal to the JAX package's, fields given as tensors.
"""

import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu.io import xdmf as jxdmf
from fenicsxfus_tpu.ops.operators import SEMOperators as JaxOps
from fenicsxfus_tpu_torch.io import xdmf
from fenicsxfus_tpu_torch.ops.operators import SEMOperators

torch.set_num_threads(1)

_TOPO = {2: ("Quadrilateral", "PolyLine", 4, 2), 3: ("Hexahedron", "Quadrilateral", 8, 4)}


def _dolfinx_files(tmp_path, dim, inline=False):
    """A DOLFINx-layout mesh file pair of a jittered box: vertices and cells
    permuted, cells in the XDMF (VTK) vertex order, a cell-tag grid listing
    the cells in another order, and a facet-tag grid (x = 0 facets 1, x = 1
    facets 2, one interior facet 5 that matches no boundary facet) in
    shuffled order. ``inline`` writes the cell tags as XML data. Returns the
    .xdmf path."""
    rng = np.random.default_rng(dim)
    base = ft.create_box((3, 2, 2)) if dim == 3 else ft.create_rectangle((4, 3))
    v = base.vertices + 0.02 * rng.standard_normal(base.vertices.shape)
    pv = rng.permutation(base.num_vertices)
    verts = np.empty_like(v)
    verts[pv] = v
    cells = pv[base.cells]
    cells = cells[rng.permutation(len(cells))]
    perm = xdmf._PERM[2**dim]
    cells_x = np.empty_like(cells)
    cells_x[:, perm] = cells  # tensor-lex -> XDMF order
    nc = len(cells)
    corder = rng.permutation(nc)
    ctags = rng.integers(1, 9, nc)
    # boundary facets on x = 0 and x = 1 by their vertex lists
    from fenicsxfus_tpu_torch.core.mesh import Mesh, _face_local_vertices, boundary_facets

    m = Mesh(dim=dim, vertices=verts[:, :dim].copy(), cells=cells)
    bf = boundary_facets(m)
    fverts, fvals = [], []
    for c, face in bf:
        axis, side = divmod(int(face), 2)
        if axis == 0:
            fverts.append(cells[c][_face_local_vertices(dim, axis, side)][::-1])
            fvals.append(1 + side)
    # the x-high face of the box's first cell (x-layer 0): interior
    fverts.append(pv[base.cells[0]][_face_local_vertices(dim, 0, 1)])
    fvals.append(5)
    forder = rng.permutation(len(fverts))
    fverts = np.asarray(fverts)[forder]
    fvals = np.asarray(fvals)[forder]
    vol, fac, npe, npf = _TOPO[dim]
    gdim = 3 if dim == 3 else 2
    with h5py.File(tmp_path / "mesh.h5", "w") as f:
        f["/Mesh/mesh/geometry"] = verts[:, :gdim]
        f["/Mesh/mesh/topology"] = cells_x
        f["/MeshTags/mesh_cells/topology"] = cells_x[corder]
        f["/MeshTags/mesh_cells/Values"] = ctags[corder]
        f["/MeshTags/mesh_facets/topology"] = fverts
        f["/MeshTags/mesh_facets/Values"] = fvals
    nv = len(verts)
    cvals = (f'<DataItem Dimensions="{nc} 1" Format="XML">'
             + " ".join(map(str, ctags[corder])) + "</DataItem>") if inline else (
        f'<DataItem Dimensions="{nc} 1" NumberType="Int" Format="HDF">'
        "mesh.h5:/MeshTags/mesh_cells/Values</DataItem>")
    text = f"""<?xml version="1.0"?>
<Xdmf Version="3.0" xmlns:xi="http://www.w3.org/2001/XInclude">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Topology TopologyType="{vol}" NumberOfElements="{nc}" NodesPerElement="{npe}">
        <DataItem Dimensions="{nc} {npe}" NumberType="Int" Format="HDF">mesh.h5:/Mesh/mesh/topology</DataItem>
      </Topology>
      <Geometry GeometryType="{'XYZ' if gdim == 3 else 'XY'}">
        <DataItem Dimensions="{nv} {gdim}" Format="HDF">mesh.h5:/Mesh/mesh/geometry</DataItem>
      </Geometry>
    </Grid>
    <Grid Name="mesh_cells" GridType="Uniform">
      <xi:include xpointer="xpointer(/Xdmf/Domain/Grid[@GridType='Uniform'][1]/Geometry)" />
      <Topology TopologyType="{vol}" NumberOfElements="{nc}" NodesPerElement="{npe}">
        <DataItem Dimensions="{nc} {npe}" NumberType="Int" Format="HDF">mesh.h5:/MeshTags/mesh_cells/topology</DataItem>
      </Topology>
      <Attribute Name="mesh_cells" AttributeType="Scalar" Center="Cell">
        {cvals}
      </Attribute>
    </Grid>
    <Grid Name="mesh_facets" GridType="Uniform">
      <xi:include xpointer="xpointer(/Xdmf/Domain/Grid[@GridType='Uniform'][1]/Geometry)" />
      <Topology TopologyType="{fac}" NumberOfElements="{len(fvals)}" NodesPerElement="{npf}">
        <DataItem Dimensions="{len(fvals)} {npf}" NumberType="Int" Format="HDF">mesh.h5:/MeshTags/mesh_facets/topology</DataItem>
      </Topology>
      <Attribute Name="mesh_facets" AttributeType="Scalar" Center="Cell">
        <DataItem Dimensions="{len(fvals)} 1" NumberType="Int" Format="HDF">mesh.h5:/MeshTags/mesh_facets/Values</DataItem>
      </Attribute>
    </Grid>
  </Domain>
</Xdmf>
"""
    path = tmp_path / "mesh.xdmf"
    path.write_text(text)
    return str(path), ctags, cells


@pytest.mark.parametrize("dim,inline", [(2, False), (3, False), (3, True)])
def test_read_mesh_matches_jax(tmp_path, dim, inline):
    path, ctags, cells = _dolfinx_files(tmp_path, dim, inline)
    got = xdmf.read_mesh(path)
    ref = jxdmf.read_mesh(path)
    assert got.dim == ref.dim == dim
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.cells, ref.cells)
    np.testing.assert_array_equal(got.cells, cells)
    np.testing.assert_array_equal(got.cell_tags, ref.cell_tags)
    np.testing.assert_array_equal(got.cell_tags, ctags)
    assert sorted(got.facet_tags) == sorted(ref.facet_tags) == [1, 2]  # 5 is interior
    for t in got.facet_tags:
        np.testing.assert_array_equal(got.facet_tags[t], ref.facet_tags[t])
    n_x0 = int(np.prod((3, 2, 2)[1:] if dim == 3 else (4, 3)[1:]))
    assert len(got.facet_tags[1]) == len(got.facet_tags[2]) == n_x0
    # every cell positively oriented after the vertex permutation
    from fenicsxfus_tpu_torch.core.geometry import volume_factors

    wdetJ, _ = volume_factors(got, 2)
    assert np.all(wdetJ > 0)


def test_read_mesh_names_and_mismatch(tmp_path):
    path, _, _ = _dolfinx_files(tmp_path, 2)
    assert xdmf.read_mesh(path, name="mesh").num_cells == 12
    with pytest.raises(ValueError, match="no mesh grid"):
        xdmf.read_mesh(path, name="other")
    with pytest.raises(ValueError, match="cell tag topology mismatch"):
        xdmf._match_cell_values(np.arange(8).reshape(2, 4), np.arange(1, 9).reshape(2, 4),
                                [1, 2])


def _pair(dim, p=2):
    """The same tagged mesh and operators in both packages (fp64)."""
    def make(mod):
        mesh = mod.create_box((3, 2, 2)) if dim == 3 else mod.create_rectangle((4, 3))
        mod.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
        return mesh

    return (SEMOperators(make(ft), p, dtype=torch.float64, device="cpu"),
            JaxOps(make(fus), p, dtype=jnp.float64))


def _same_files(a_base, b_base):
    assert open(a_base + ".xdmf").read() == open(b_base + ".xdmf").read()
    with h5py.File(a_base + ".h5") as fa, h5py.File(b_base + ".h5") as fb:
        names = []
        fa.visit(names.append)
        ref = []
        fb.visit(ref.append)
        assert names == ref
        for n in names:
            if isinstance(fa[n], h5py.Dataset):
                assert fa[n].dtype == fb[n].dtype, n
                np.testing.assert_array_equal(fa[n][()], fb[n][()])


@pytest.mark.parametrize("dim", [2, 3])
def test_writers_match_jax(tmp_path, dim):
    ops, jops = _pair(dim)
    rng = np.random.default_rng(7)
    u = rng.standard_normal(ops.ndofs)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    xdmf.write_xdmf_field(str(tmp_path / "a" / "f.xdmf"), ops, torch.from_numpy(u), "p")
    jxdmf.write_xdmf_field(str(tmp_path / "b" / "f.xdmf"), jops, jnp.asarray(u), "p")
    _same_files(str(tmp_path / "a" / "f"), str(tmp_path / "b" / "f"))
    frames = [rng.standard_normal(ops.ndofs) for _ in range(3)]
    with xdmf.XDMFTimeSeriesWriter(str(tmp_path / "a" / "m.xdmf"), ops) as w:
        for i, f in enumerate(frames):
            w.write(torch.from_numpy(f).float(), 0.1 * i)
    with jxdmf.XDMFTimeSeriesWriter(str(tmp_path / "b" / "m.xdmf"), jops) as w:
        for i, f in enumerate(frames):
            w.write(jnp.asarray(f, jnp.float32), 0.1 * i)
    _same_files(str(tmp_path / "a" / "m"), str(tmp_path / "b" / "m"))
    xdmf.save_field_npz(str(tmp_path / "a" / "s.npz"), ops, {"u": torch.from_numpy(u)}, t=0.5)
    jxdmf.save_field_npz(str(tmp_path / "b" / "s.npz"), jops, {"u": jnp.asarray(u)}, t=0.5)
    a, b = np.load(tmp_path / "a" / "s.npz"), np.load(tmp_path / "b" / "s.npz")
    assert sorted(a.files) == sorted(b.files) == ["coords", "t", "u"]
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_vertex_values_one_host_copy_and_lattice_shape():
    """``_vertex_values`` takes a tensor in the lattice shape as well as
    flat, and equals the JAX restriction."""
    ops, jops = _pair(3)
    u = np.random.default_rng(3).standard_normal(ops.ndofs)
    ref = jxdmf._vertex_values(jops, jnp.asarray(u))
    np.testing.assert_array_equal(xdmf._vertex_values(ops, torch.from_numpy(u)), ref)
    np.testing.assert_array_equal(
        xdmf._vertex_values(ops, torch.from_numpy(u).view(ops.gdims)), ref)


def test_write_movie_matches_jax(tmp_path):
    """``write_movie`` of the 2D plane-wave channel, fp64: the same frame
    times and vertex values (1e-10) as the JAX package's."""
    def model(mod, dtype, **kw):
        mesh = mod.create_rectangle((11, 2), (0, 0), (1.0, 0.2))
        mod.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
        m = mod.LinearSpectralExplicit(mesh, None, 2, 1.0, 4.0, 10.0, 4.0, 1.0, 4,
                                       0.9 / 11 / 4, dtype=dtype, **kw)
        m.init()
        return m

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ta = xdmf.write_movie(model(ft, torch.float64, device="cpu"), 0.0, 0.3,
                          str(tmp_path / "a" / "mv.xdmf"), n_frames=3)
    tb = jxdmf.write_movie(model(fus, jnp.float64), 0.0, 0.3, str(tmp_path / "b" / "mv.xdmf"),
                           n_frames=3)
    np.testing.assert_array_equal(ta, tb)
    assert open(tmp_path / "a" / "mv.xdmf").read() == open(tmp_path / "b" / "mv.xdmf").read()
    with h5py.File(tmp_path / "a" / "mv.h5") as fa, h5py.File(tmp_path / "b" / "mv.h5") as fb:
        for i in range(4):
            a, b = fa[f"/fields/u/{i}"][()], fb[f"/fields/u/{i}"][()]
            assert np.max(np.abs(a - b)) <= 1e-10 * max(np.max(np.abs(b)), 1e-300)
        assert np.max(np.abs(fb["/fields/u/3"][()])) > 0


def test_no_jax_and_lazy_h5py():
    """The module imports neither jax nor h5py (h5py is imported where an
    HDF5 file is read or written)."""
    import subprocess
    import sys

    code = ("import sys; import fenicsxfus_tpu_torch.io.xdmf; "
            "assert 'jax' not in sys.modules and 'h5py' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
