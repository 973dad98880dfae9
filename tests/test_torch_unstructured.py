"""The general per-cell operator path of the PyTorch port against the JAX
package's, fp64 on the CPU: unstructured meshes (the entity-blocked
numbering), deformed lattices (the lattice numbering, per-cell geometry)
and uniform lattices that are not axis-aligned (the shared element matrix
``K_ref``), on meshes built from a seed in numpy.

Operators (gather, the deterministic fold ``scatter``, ``scatter_segsum``,
``stiffness_apply`` through the dense tabulation and with
``FUS_DENSE_TAB=0``, ``stiffness_apply_generic``, ``assemble_diag``,
``stiffness_diag``, ``facet_vector``) agree to 1e-12 relative; model runs
(explicit, implicit with the same CG counts, ``rk_record`` with off-node
sensors) to 1e-10. Also: the chunked ``quadrature_factors`` equals the
unchunked bit for bit, and ``convert.consts_from_numpy`` carries a
general-path coefficient across.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
from fenicsxfus_tpu.core import mesh as jmesh
from fenicsxfus_tpu.ops.operators import SEMOperators as JaxOps
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.convert import consts_from_numpy, state_from_numpy
from fenicsxfus_tpu_torch.core import geometry as tgeom
from fenicsxfus_tpu_torch.core import mesh as tmesh
from fenicsxfus_tpu_torch.core.gll import gll_points_weights_01
from fenicsxfus_tpu_torch.ops.operators import SEMOperators
from fenicsxfus_tpu_torch.tools import unstructured_solve as tus

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "unstructured_solve_bench",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "benchmarks", "unstructured_solve.py"),
)
jus = importlib.util.module_from_spec(_spec)
sys.modules.setdefault("unstructured_solve_bench", jus)
_spec.loader.exec_module(jus)


def _rel(a, b) -> float:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _base(mod, dim):
    """Unit-size cells, so O(1) coefficients give an O(1) stiffness term."""
    if dim == 1:
        return mod.create_interval(7, 0.0, 7.0)
    if dim == 2:
        return mod.create_rectangle((4, 3), (0, 0), (4.0, 3.0))
    return mod.create_box((3, 2, 2), (0, 0, 0), (3.0, 2.0, 2.0))


def distort_lattice(mesh, amp=0.15, seed=0):
    """``tests/test_operators.py::distort``: interior vertices jittered in
    place; the mesh keeps its ``grid_shape`` (lattice numbering)."""
    rng = np.random.default_rng(seed)
    v = mesh.vertices
    lo, hi = v.min(axis=0), v.max(axis=0)
    interior = np.all((v > lo + 1e-12) & (v < hi - 1e-12), axis=1)
    h = (hi - lo).max() / max(np.asarray(mesh.grid_shape).max(), 1)
    v[interior] += amp * h * (rng.random((interior.sum(), mesh.dim)) - 0.5)
    mesh.uniform_hint = False
    return mesh


def distort_unstructured(mod, base, w=0.07, seed=0):
    """``tests/test_conn.py::distort``: a smooth distortion and a vertex
    relabelling, no ``grid_shape`` (the entity-blocked numbering)."""
    rng = np.random.default_rng(seed)
    v = base.vertices.copy()
    d = base.dim
    for a in range(d):
        v[:, a] += w * np.sin(np.pi * v[:, (a + 1) % d] / 3.0 + 0.3 * a)
    perm = rng.permutation(base.num_vertices)
    v2 = np.empty_like(v)
    v2[perm] = v
    return mod.Mesh(dim=d, vertices=v2, cells=perm[base.cells])


def _tag(mod, mesh):
    mod.tag_boundaries(mesh, {1: lambda x: x[0] < 1.5, 2: lambda x: x[0] >= 1.5})
    return mesh


def _mesh(mod, dim, kind):
    base = _base(mod, dim)
    m = distort_lattice(base) if kind == "lattice-numbered" else distort_unstructured(mod, base)
    return _tag(mod, m)


def _ops(dim, kind, degree):
    t = SEMOperators(_mesh(tmesh, dim, kind), degree, dtype=torch.float64, device="cpu")
    j = JaxOps(_mesh(jmesh, dim, kind), degree, dtype=jnp.float64)
    assert t.lattice is None and t.hybrid is None and t.gdims is None and j.lattice is None
    assert t.ndofs == j.ndofs
    return t, j


@pytest.mark.parametrize("kind", ["lattice-numbered", "unstructured"])
@pytest.mark.parametrize("degree", [1, 2, 4])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_general_operators_match_jax(dim, degree, kind, monkeypatch):
    t, j = _ops(dim, kind, degree)
    assert np.array_equal(t.space.dofmap, np.asarray(j.space.dofmap))
    rng = np.random.default_rng(dim * 10 + degree)
    xs = rng.standard_normal((2, t.ndofs))
    cs = [rng.uniform(0.5, 2.0, t.num_cells), 0.7]
    tx = [torch.from_numpy(x) for x in xs]
    jx = [jnp.asarray(x) for x in xs]
    # gather and the two folds
    assert np.array_equal(t.gather(tx[0]).numpy(), np.asarray(j.gather(jx[0])))
    yc = rng.standard_normal((t.num_cells,) + (t.N,) * dim)
    ref = np.asarray(j.scatter(jnp.asarray(yc)))
    assert _rel(t.scatter(torch.from_numpy(yc)), ref) < 1e-12
    assert _rel(t.scatter_segsum(torch.from_numpy(yc)), j.scatter_segsum(jnp.asarray(yc))) < 1e-12
    # the stiffness: the default route, the sum-factorised one, the oracle
    ref = np.asarray(j.stiffness_apply(jx, [j.stiff_coeff(c) for c in cs]))
    gen = np.asarray(j.stiffness_apply_generic(jx, cs))
    assert _rel(gen, ref) < 1e-12
    y = t.stiffness_apply(tx, [t.stiff_coeff(c) for c in cs])
    assert y.shape == (t.ndofs,) and _rel(y, ref) < 1e-12
    assert _rel(t.stiffness_apply_generic(tx, cs), gen) < 1e-12
    monkeypatch.setenv("FUS_DENSE_TAB", "0")
    assert _rel(t.stiffness_apply(tx, cs), np.asarray(j.stiffness_apply(jx, cs))) < 1e-12
    # the diagonals and the facet vectors
    for c in cs:
        m = t.assemble_diag(c)
        assert isinstance(m, np.ndarray) and m.dtype == np.float64
        assert _rel(m, j.assemble_diag(c)) < 1e-12
        assert _rel(t.stiffness_diag(c), j.stiffness_diag(c)) < 1e-12
        for tag in (1, 2):
            assert _rel(t.facet_vector(tag, c), j.facet_vector(tag, c)) < 1e-12


def _rotated(mod, dim):
    """A uniform lattice turned off the axes and sheared: every cell a
    translate of the first (``uniform_hint``), G with off-diagonal terms."""
    m = _base(mod, dim)
    th = 0.4
    A = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]) @ [[1.0, 0.3], [0.0, 1.2]]
    if dim == 3:
        A = np.block([[A, np.zeros((2, 1))], [np.zeros((1, 2)), np.ones((1, 1))]])
        A = A @ np.array([[1, 0, 0], [0, np.cos(0.3), -np.sin(0.3)], [0, np.sin(0.3), np.cos(0.3)]])
    m.vertices = m.vertices @ A.T
    return m


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("dim", [2, 3])
def test_rotated_uniform_lattice_takes_k_ref(dim, degree):
    """A uniform lattice that is not axis-aligned: the general path's
    shared element matrix ``K_ref``, against the JAX package's."""
    t = SEMOperators(_rotated(tmesh, dim), degree, dtype=torch.float64, device="cpu")
    j = JaxOps(_rotated(jmesh, dim), degree, dtype=jnp.float64)
    assert t.uniform and t.lattice is None and t.K_ref is not None and j.K_ref is not None
    rng = np.random.default_rng(degree)
    x = rng.standard_normal(t.ndofs)
    c = rng.uniform(0.5, 2.0, t.num_cells)
    ref = np.asarray(j.stiffness_apply([jnp.asarray(x)], [j.stiff_coeff(c)]))
    assert _rel(t.stiffness_apply([torch.from_numpy(x)], [t.stiff_coeff(c)]), ref) < 1e-12
    assert _rel(t.stiffness_apply_generic([torch.from_numpy(x)], [c]), ref) < 1e-12
    assert _rel(t.assemble_diag(c), j.assemble_diag(c)) < 1e-12
    assert _rel(t.stiffness_diag(c), j.stiffness_diag(c)) < 1e-12


def test_as_unstructured_box_equals_lattice_path():
    """``as_unstructured`` of a box of unit cells: the general path (blocked
    numbering, ``K_ref``) equals the lattice path of the same box once the
    numberings are matched cell node by cell node, with O(1) coefficients."""
    box = tmesh.create_box((4, 3, 3), (0, 0, 0), (4.0, 3.0, 3.0))
    lat = SEMOperators(box, 4, dtype=torch.float64, device="cpu")
    gen = SEMOperators(ft.as_unstructured(box), 4, dtype=torch.float64, device="cpu")
    assert lat.lattice is not None and gen.lattice is None and gen.K_ref is not None
    to_lat = np.empty(gen.ndofs, np.int64)
    to_lat[gen.space.dofmap.reshape(-1)] = lat.space.dofmap.reshape(-1)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(lat.ndofs)
    c = rng.uniform(0.5, 2.0, box.num_cells)
    y_lat = lat.stiffness_apply([torch.from_numpy(x)], [lat.stiff_coeff(c)]).numpy()
    y_gen = gen.stiffness_apply([torch.from_numpy(x[to_lat])], [gen.stiff_coeff(c)]).numpy()
    assert _rel(y_gen, y_lat[to_lat]) < 1e-12
    assert _rel(gen.assemble_diag(c), lat.assemble_diag(c)[to_lat]) < 1e-12
    assert _rel(gen.stiffness_diag(c), lat.stiffness_diag(c).numpy()[to_lat]) < 1e-12
    jgen = JaxOps(jmesh.as_unstructured(jmesh.create_box((4, 3, 3), (0, 0, 0), (4.0, 3.0, 3.0))),
                  4, dtype=jnp.float64)
    assert _rel(y_gen, jgen.stiffness_apply([jnp.asarray(x[to_lat])], [c])) < 1e-12


def test_fold_is_deterministic_and_covers_every_dof():
    """The fold's valence classes partition the DOFs, and the same input
    gives the same bits twice."""
    t, _ = _ops(3, "unstructured", 4)
    dofs = torch.cat([d for d, _ in t.fold_plan])
    assert torch.equal(torch.sort(dofs).values, torch.arange(t.ndofs))
    lens = np.bincount(t.space.scatter_segids, minlength=t.ndofs)
    assert sorted(int(tb.numel() // d.numel()) for d, tb in t.fold_plan) == sorted(set(lens))
    yc = torch.from_numpy(np.random.default_rng(3).standard_normal((t.num_cells,) + (t.N,) * 3))
    assert torch.equal(t.scatter(yc), t.scatter(yc))


@pytest.mark.parametrize("chunk,parallel", [(1, False), (7, False), (5, True)])
def test_quadrature_factors_chunked_equal_unchunked(chunk, parallel, monkeypatch):
    """The chunked geometry factors, in this process or spread over worker
    processes, equal the one-chunk result bit for bit, and the JAX package's
    numpy path."""
    mesh = _mesh(tmesh, 3, "unstructured")
    x1, w1 = gll_points_weights_01(5)
    whole = tgeom.quadrature_factors(mesh, x1, w1)
    assert mesh.num_cells < tgeom.CHUNK_CELLS
    monkeypatch.setenv("FUS_NATIVE", "0")  # the workers, not the native library
    monkeypatch.setattr(tgeom, "CHUNK_CELLS", chunk)
    monkeypatch.setattr(tgeom, "PARALLEL_CELLS", 1 if parallel else 10**9)
    got = tgeom.quadrature_factors(mesh, x1, w1)
    from fenicsxfus_tpu.core.geometry import quadrature_factors as jq

    ref = jq(_mesh(jmesh, 3, "unstructured"), x1, w1)
    for a, b, r in zip(got, whole, ref):
        assert np.array_equal(a, b) and np.array_equal(a, r)


def _children() -> set[int]:
    """Pids of this process's living children (Linux ``/proc``)."""
    pids = set()
    for task in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{task}/children") as f:
            pids.update(int(p) for p in f.read().split())
    return pids


@pytest.mark.parametrize("degenerate", [False, True])
def test_quadrature_factors_workers_end(degenerate, monkeypatch):
    """The geometry workers have all ended when ``quadrature_factors``
    returns, and when a worker's failure makes it raise."""
    mesh = _mesh(tmesh, 3, "unstructured")
    if degenerate:
        mesh = tmesh.Mesh(dim=3, vertices=np.zeros_like(mesh.vertices), cells=mesh.cells)
    x1, w1 = gll_points_weights_01(3)
    monkeypatch.setenv("FUS_NATIVE", "0")  # the workers, not the native library
    monkeypatch.setattr(tgeom, "CHUNK_CELLS", 4)
    monkeypatch.setattr(tgeom, "PARALLEL_CELLS", 1)
    before = _children()
    if degenerate:
        with pytest.raises(RuntimeError, match="geometry worker ended"):
            tgeom.quadrature_factors(mesh, x1, w1)
    else:
        tgeom.quadrature_factors(mesh, x1, w1)
    assert _children() <= before


def _scrambled_2d(mod):
    """The scrambled 2D mesh of ``tests/test_blocked.py:118``."""
    base = mod.create_rectangle((8, 5), (0, 0), (1.0, 0.6))
    v = base.vertices.copy()
    v[:, 1] += 0.02 * np.sin(np.pi * v[:, 0]) * np.sin(np.pi * v[:, 1])
    rng = np.random.default_rng(7)
    perm = rng.permutation(base.num_vertices)
    v2 = np.empty_like(v)
    v2[perm] = v
    mesh = mod.Mesh(dim=2, vertices=v2, cells=perm[base.cells])
    mod.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > 0.99})
    return mesh


def test_linear_explicit_on_scrambled_2d_mesh_matches_jax():
    args = (None, 3, 1.0, 1.0, 10.0, 1.0, 1.0, 4, 4e-4)
    tm = ft.LinearSpectralExplicit(_scrambled_2d(tmesh), *args, dtype=torch.float64,
                                   device="cpu")
    jm = fus.LinearSpectralExplicit(_scrambled_2d(jmesh), *args, dtype=jnp.float64)
    assert tm.ops.lattice is None and tm.step_kind == "unfused"
    ju, jv, _ = jm.init().rk(0.0, 0.03)
    tu, tv, _ = tm.init().rk(0.0, 0.03)
    assert float(np.max(np.abs(np.asarray(ju)))) > 0
    assert _rel(tu, ju) < 1e-12 and _rel(tv, jv) < 1e-12


def test_westervelt_distorted_box_matches_jax():
    """``tools/unstructured_solve.py``'s distorted box and Westervelt model
    (the mesh equal to ``benchmarks/unstructured_solve.py``'s) against the
    JAX package's, 12 RK4 steps from a seeded state."""
    tmesh_, jmesh_ = tus.distorted_box(3), jus.distorted_box(3, 2)
    assert np.array_equal(tmesh_.vertices, jmesh_.vertices)
    assert np.array_equal(tmesh_.cells, jmesh_.cells)
    tm = tus.build_model(tmesh_, 2, torch.float64, "cpu")
    dt = 0.4 * jmesh_.h_min() / (tus.C0 * 4)
    jm = fus.WesterveltSpectralExplicit(jmesh_, None, 2, 1.5, 1.0, 4e-3, 3.5, 10.0, 1.0, 1.5, 4,
                                        dt, dtype=jnp.float64)
    assert tm.dt == dt
    rng = np.random.default_rng(5)
    u0, v0 = 1e-2 * rng.standard_normal(tm.ops.ndofs), rng.standard_normal(tm.ops.ndofs)
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    tm.u_n, tm.v_n = state_from_numpy(u0, v0, device="cpu")
    ju, jv, _ = jm.rk(0.0, 12 * dt)
    tu, tv, _ = tm.rk(0.0, 12 * dt)
    assert tm.step_kind == "unfused"
    assert _rel(tu, ju) < 1e-10 and _rel(tv, jv) < 1e-10


def test_unstructured_solve_tool_runs():
    res, gap = tus.main(nx=3, degree=2, steps=3, dtype=torch.float64, device="cpu",
                        say=lambda s: None)
    assert [r["label"] for r in res] == ["lattice", "unstructured", "unstructured+reorder"]
    assert [r["step_kind"] for r in res] == ["fused", "unfused", "unfused"]
    assert len({r["ndofs"] for r in res}) == 1 and gap > 0
    for r in res:
        assert torch.isfinite(r["u"]).all() and r["gdof_steps_per_s"] > 0


def test_lossy_implicit_on_distorted_mesh_matches_jax():
    """SDIRK on an unstructured distorted box: u and v to 1e-10, the same
    worst CG iteration count."""
    args = (None, 2, 1.0, 1.0, 1e-3, 10.0, 1.0, 1.0, 4, 1e-2)
    tm = ft.LossySpectralImplicit(_mesh(tmesh, 3, "unstructured"), *args, device="cpu")
    jm = fus.LossySpectralImplicit(_mesh(jmesh, 3, "unstructured"), *args, dtype=jnp.float64)
    assert tm.ops.lattice is None
    rng = np.random.default_rng(5)
    u0, v0 = 1e-3 * rng.standard_normal(jm.ops.ndofs), rng.standard_normal(jm.ops.ndofs)
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    tm.u_n, tm.v_n = state_from_numpy(u0, v0, device="cpu")
    ju, jv, _ = jm.dirk(0.0, 4 * tm.dt)
    tu, tv, _ = tm.dirk(0.0, 4 * tm.dt)
    assert _rel(tu, ju) < 1e-10 and _rel(tv, jv) < 1e-10
    assert tm.cg_stats["max_iterations"] == jm.cg_stats["max_iterations"] > 0


def _sensor_models():
    args = (None, 3, 1.5, 1.0, 0.5, 1.0, 1.5, 4, 2e-3)
    tm = ft.LinearSpectralExplicit(_mesh(tmesh, 3, "unstructured"), *args,
                                   dtype=torch.float64, device="cpu")
    jm = fus.LinearSpectralExplicit(_mesh(jmesh, 3, "unstructured"), *args, dtype=jnp.float64)
    return tm, jm


def test_rk_record_off_node_sensors_match_jax():
    """Off-node sensors on an unstructured mesh: located by the Newton
    inverse map and interpolated, against the JAX ``rk_record``."""
    tm, jm = _sensor_models()
    pts = np.stack([np.array([0.37, 1.21, 2.55]), np.array([0.61, 1.03, 1.47]),
                    np.array([0.29, 0.88, 1.13])])
    rows, wts = tm.sensor_interp_tables(pts)
    jrows, jwts = jm.sensor_interp_tables(pts)
    assert np.array_equal(rows, jrows) and _rel(wts, jwts) < 1e-13
    assert np.abs(wts).max(axis=1).min() < 0.9  # off node: the interpolating gather
    rng = np.random.default_rng(2)
    u0, v0 = rng.standard_normal(jm.ops.ndofs), rng.standard_normal(jm.ops.ndofs)
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    tm.u_n, tm.v_n = state_from_numpy(u0, v0, device="cpu")
    _, _, jt, jtimes, jys = jm.rk_record(0.0, 5 * tm.dt, pts)
    _, _, tt, times, ys = tm.rk_record(0.0, 5 * tm.dt, pts)
    assert ys.shape == (5, 3) and np.array_equal(times, jtimes)
    assert _rel(ys, jys) < 1e-10
    with pytest.raises(ValueError, match="outside the mesh"):
        tm.sensor_interp_tables(np.array([[9.0], [0.5], [0.5]]))


def test_sensor_indices_match_jax():
    tm, jm = _sensor_models()
    rng = np.random.default_rng(8)
    pts = rng.uniform([0, 0, 0], [3, 2, 2], (20, 3)).T
    assert np.array_equal(tm.sensor_indices(pts), jm.sensor_indices(pts))


def test_general_coefficient_carries_across():
    """The JAX model's consts on the general path (``coeff_u`` a [Nc] DG-0
    array from its ``stiff_coeff``) carried across by
    ``convert.consts_from_numpy`` equal the port's own, and drive the same
    step."""
    tm, jm = _sensor_models()
    np_consts = {k: (np.asarray(v) if not np.isscalar(v) else v) for k, v in jm.consts.items()}
    conv = consts_from_numpy(np_consts, device="cpu")
    assert set(conv) == set(tm.consts)
    assert conv["coeff_u"].shape == (tm.ops.num_cells,)
    for k, v in conv.items():
        if isinstance(v, float):
            assert v == tm.consts[k], k
        else:
            assert _rel(v, tm.consts[k]) < 1e-13, k
    rng = np.random.default_rng(4)
    u, v = state_from_numpy(rng.standard_normal(tm.ops.ndofs),
                            rng.standard_normal(tm.ops.ndofs), device="cpu")
    step = tm.unfused_step()
    a = step(conv, (u, v, 0.0), tm.dt)
    b = step(tm.consts, (u, v, 0.0), tm.dt)
    assert _rel(a[0], b[0]) < 1e-13 and _rel(a[1], b[1]) < 1e-13


def test_general_path_takes_the_unfused_step():
    tm, _ = _sensor_models()
    assert tm.fused_step() is None and tm.step_kind == "unfused"
    assert isinstance(tm.consts["coeff_u"], torch.Tensor)


def test_mesh_exports():
    assert ft.bowl_cap_area(0.7, 0.35) > 0
    assert callable(ft.compute_eval_params)
    for name in ("bowl_cap_area", "compute_eval_params", "as_unstructured", "reorder_locality"):
        assert name in ft.__all__
