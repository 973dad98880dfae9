"""The port's unstructured split (``fenicsxfus_tpu_torch/parallel/
unstructured.py``, gloo ranks on the CPU) against the JAX package's
(``fenicsxfus_tpu/parallel/unstructured.py`` on the suite's virtual CPU
devices): the cases of ``tests/test_unstructured_sharding.py`` (not the
TPU-only gather/scatter schedules), the unstructured cases of
``tests/test_sharded_recording.py`` and
``tests/test_hybrid.py::test_bowl_mesh_shards_via_unstructured``, each run
three ways in fp64 from the same inputs (the JAX sharded solver at ndev = n,
the port at world size n, the port's model on one device) and held at
1e-11 on u, v and the sensor traces, the CG's worst iteration count within
2. The JAX suite's 8-device uneven case runs here as 9 cells over 4 ranks,
3, 3, 3 and none. The JAX suite's slow cases (the 3D Westervelt, the
implicit 2D and the clustered sensors) are slow here too, with a launch of
their own. Also the partition tables and dot weights against the JAX
package's (no ranks needed), the implicit recording's dot weights, and the
refusals.

The ranks start through ``parallel.launch.spawn`` (one launch per world
size, ``runs.run_cases``); JAX's 8 virtual devices come from
``tests/conftest.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import fenicsxfus_tpu as fus
from fenicsxfus_tpu.core.mesh import Mesh as JMesh
from fenicsxfus_tpu.core.mesh import as_unstructured as jas_unstructured
from fenicsxfus_tpu.ops.operators import SEMOperators as JSEMOperators
from fenicsxfus_tpu.parallel import unstructured as jun
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.parallel import runs, spawn
from fenicsxfus_tpu_torch.parallel import unstructured as tun

torch.set_num_threads(1)


def scrambled(n, hi, seed=0, w=0.25):
    """The JAX suite's ``unstructured(create_*(n), w, seed)``: interior
    vertices jittered by w·h, vertex ids permuted."""
    nv = int(np.prod(np.asarray(n) + 1))
    h = min(hi) / max(nv ** (1.0 / len(n)), 2.0)
    return ("jittered", n, (0.0,) * len(n), hi, seed, w * h, True)


def jittered(n, hi, seed):
    return ("jittered", n, (0.0,) * len(n), hi, seed, 0.02, False)


def _spec(name, world, mesh, model, args, run, t_end, **extra):
    return name, (world, dict({"name": name, "mesh": mesh, "tag_L": 1.0, "model": model,
                               "args": args, "dtype": "float64", "run": run, "t_end": t_end,
                               "decomp": "unstructured"}, **extra))


LIN2 = (3, 1.0, 1.0, 2.0, 1.0, 1.0, 4, 0.002)
AX = lambda n: np.stack([np.linspace(0.05, 0.95, n), np.full(n, 0.2), np.full(n, 0.2)])  # noqa: E731
_r = np.random.default_rng(3)
CLUSTERED = np.stack([_r.uniform(0.11, 0.21, 12), _r.uniform(0.05, 0.35, 12),
                      _r.uniform(0.05, 0.35, 12)])
BOWL = ("bowl", ((8, 6, 6), (0, 0, 0), (1.0, 0.7, 0.7), 0.5, 0.25), {})
DT_BOWL = 0.4 * runs.make_mesh({"mesh": BOWL}).h_min() / 4.0
CASES = dict([
    *[_spec(f"linear_2d_{w}", w, scrambled((7, 5), (1.0, 1.0)), "LinearSpectralExplicit", LIN2,
            "rk", 0.03) for w in (2, 4)],
    # 9 cells over 4 ranks: 3, 3, 3 and none
    _spec("empty_rank", 4, scrambled((3, 3), (1.0, 1.0)), "LinearSpectralExplicit",
          (2, 1.0, 1.0, 2.0, 1.0, 1.0, 4, 0.002), "rk", 0.02),
    *[_spec(mode, 4, scrambled((6, 6), (1.0, 1.0)), "LinearSpectralExplicit", LIN2, "rk", 0.02,
            partition=mode) for mode in ("axis", "morton")],
    _spec("dirk_record", 4, jittered((7, 3, 3), (1.0, 0.4, 0.4), 2), "LinearSpectralImplicit",
          (2, 1.5, 1.0, 10.0, 1.0, 1.5, 2, 0.05), "dirk_record", 0.3, points=AX(5),
          kwargs={"cg_rtol": 1e-12}),
    _spec("rk_record", 4, jittered((7, 3, 3), (1.0, 0.4, 0.4), 0),
          "WesterveltSpectralExplicit",
          (2, 1.5, 1.0, 4e-3, 3.5, 10.0, 1.0, 1.5, 4, 0.15 / 7 / 1.5 / 4), "rk_record",
          30 * 0.15 / 7 / 1.5 / 4, points=AX(6)),
    _spec("bowl", 4, BOWL, "LinearSpectralExplicit", (2, 1.0, 1.0, 3.0, 1.0, 1.0, 4, DT_BOWL),
          "rk", 30 * DT_BOWL, as_unstructured=True, tag_L=None),
])


# the JAX suite's slow cases, slow here too: a launch of their own
SLOW = dict([
    _spec("westervelt_3d", 4, scrambled((4, 3, 3), (1.0, 1.0, 1.0), seed=3),
          "WesterveltSpectralExplicit", (2, 1.0, 1.0, 1e-3, 2.0, 2.0, 1.0, 1.0, 4, 0.002), "rk",
          0.02),
    _spec("implicit_2d", 4, scrambled((5, 4), (1.0, 1.0)), "LinearSpectralImplicit",
          (3, 1.0, 1.0, 2.0, 1.0, 1.0, 2, 0.004), "dirk", 0.02, kwargs={"cg_rtol": 1e-12}),
    # 12 off-node sensors on one rank's cells: 12 * 64 virtual rows there
    _spec("clustered", 4, ("box", (9, 3, 3), (0.0, 0.0, 0.0), (1.0, 0.4, 0.4)),
          "LinearSpectralExplicit", (3, 1.5, 1.0, 10.0, 1.0, 1.5, 4, 0.4 / 9 / 1.5 / 9),
          "rk_record", 8 * 0.4 / 9 / 1.5 / 9, points=CLUSTERED, as_unstructured=True),
])


def _launch(cases) -> dict:
    """Every case's port run on every rank: {name: [rank 0's result, ...]};
    one gloo launch per world size."""
    out = {}
    for world in sorted({w for w, _ in cases.values()}):
        names = [n for n, (w, _) in cases.items() if w == world]
        per_rank = spawn(runs.run_cases, world, "gloo", "cpu",
                         args=([cases[n][1] for n in names],))
        for i, name in enumerate(names):
            out[name] = [r[i] for r in per_rank]
    return out


@pytest.fixture(scope="module")
def port():
    return _launch(CASES)


@pytest.fixture(scope="module")
def port_slow():
    return _launch(SLOW)


def jax_mesh(spec):
    """The case's mesh for the JAX package: the port's vertices, cells and
    facet tags (the same seeded jitter), tagged the same way."""
    pm = runs.make_mesh(spec)
    mesh = JMesh(dim=pm.dim, vertices=pm.vertices, cells=pm.cells,
                 facet_tags=dict(pm.facet_tags))
    if spec.get("tag_L") is not None:
        fus.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1.0 - 1e-12})
    return mesh


def jax_run(spec, ndev) -> dict:
    m = getattr(fus, spec["model"])(jax_mesh(spec), None, *spec["args"], dtype=jnp.float64,
                                    **spec.get("kwargs", {}))
    m.init()
    implicit = spec["run"].startswith("dirk")
    cls = jun.ShardedUnstructuredImplicitSolver if implicit else jun.ShardedUnstructuredExplicitSolver
    sol = cls(m, ndev, partition=spec.get("partition", "auto"))
    out = {"sol": sol}
    if spec["run"].endswith("_record"):
        u, v, _, out["times"], out["ys"] = getattr(sol, spec["run"])(0.0, spec["t_end"],
                                                                      spec["points"])
    else:
        u, v, _ = getattr(sol, spec["run"])(0.0, spec["t_end"])
    out.update(u=np.asarray(u), v=np.asarray(v))
    if implicit:
        out["cg"] = m.cg_stats["max_iterations"]
    return out


def rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(np.max(np.abs(b)), 1e-300))


def held(port, name, tol=1e-11, keys=("u", "v")):
    """The port at world size n against the JAX sharded run at ndev = n and
    the port's one device, on ``keys``; every rank holds the same global
    fields (the shared rows complete to the same bits on every holder)."""
    world, spec = {**CASES, **SLOW}[name]
    got = port[name][0]
    for other in port[name][1:]:
        for key in keys:
            assert np.array_equal(other[key], got[key]), (name, key)
    ref = jax_run(spec, world)
    single = runs.run_single(spec, torch.device("cpu"))
    for key in keys:
        assert rel(got[key], ref[key]) < tol, (name, key, "jax", rel(got[key], ref[key]))
        assert rel(got[key], single[key]) < tol, (name, key, "single", rel(got[key], single[key]))
    if "times" in ref:
        np.testing.assert_allclose(got["times"], ref["times"], rtol=0, atol=1e-14)
    return got, ref, single


@pytest.mark.parametrize("world", [2, 4])
def test_unstructured_linear_2d(port, world):
    held(port, f"linear_2d_{world}")


@pytest.mark.slow
def test_unstructured_westervelt_3d(port_slow):
    held(port_slow, "westervelt_3d")


@pytest.mark.slow
def test_unstructured_implicit_2d(port_slow):
    """The CG's holder-weighted dots reduced over the ranks: the worst
    iteration count within 2 of the JAX run's and the one device's; each
    rank's weights 1/(holders) of its DOFs."""
    got, ref, single = held(port_slow, "implicit_2d")
    assert 1 <= got["cg"] < 2000
    assert abs(got["cg"] - ref["cg"]) <= 2 and abs(got["cg"] - single["cg"]) <= 2
    want = _holder_weights(SLOW["implicit_2d"][1], 3, 4)
    for r, res in enumerate(port_slow["implicit_2d"]):
        np.testing.assert_array_equal(res["weights"], want[r])


def test_uneven_partition_with_an_empty_rank(port):
    """9 cells over 4 ranks: the last rank holds no cells and no DOFs, and
    still joins every exchange, gather and reduction."""
    got, _, _ = held(port, "empty_rank")
    assert [r["local_ndofs"] > 0 for r in port["empty_rank"]] == [True, True, True, False]


def test_partition_modes_equivalent(port):
    """The axis and Morton partitions of one model agree to fp roundoff,
    each against the JAX run of its own mode."""
    for mode in ("axis", "morton"):
        held(port, mode)
    a, b = port["axis"][0], port["morton"][0]
    assert rel(a["u"], b["u"]) < 1e-11 and rel(a["v"], b["v"]) < 1e-11


def _tables_case(kind, n, ndev, partition="auto", degree=2):
    hi = (1.0,) * len(n) if kind != "long" else (4.0, 0.5, 0.5)
    spec = {"mesh": scrambled(n, hi, seed=1 if kind == "cube" else 0)}
    pm = runs.make_mesh(spec)
    jm = JMesh(dim=pm.dim, vertices=pm.vertices, cells=pm.cells)
    return pm, jm, degree, ndev, partition


@pytest.mark.parametrize("case", [("rect", (7, 5), 2), ("rect", (7, 5), 4), ("box", (4, 3, 3), 4),
                                  ("cube", (4, 4, 4), 8)])
def test_partition_tables_and_dot_weights_match_jax(case):
    """``partition_tables`` (no process group) gives the JAX package's cell
    partition, mode and shared-row payload for the same mesh and rank
    count, and ``holder_weights`` its dot weights DOF by DOF on each rank."""
    pm, jm, degree, ndev, partition = _tables_case(*case)
    jops = JSEMOperators(jm, degree, dtype=jnp.float64)
    jdec = jun.UnstructuredDecomposition(jm, degree, ndev, jnp.float64, space=jops.space)
    tables = tun.partition_tables(pm, degree, ndev)
    np.testing.assert_array_equal(tables["cell_ids"], jdec.cell_ids)
    np.testing.assert_array_equal(tables["cell_valid"], jdec.cell_valid)
    assert tables["partition_mode"] == jdec.partition_mode
    assert tables["shared_payload"] == jdec.shared_payload
    assert (tables["nsf"], tables["nse"], tables["nsv"]) == (jdec.nsf, jdec.nse, jdec.nsv)
    space = ft.SEMOperators(pm, degree, torch.float64, "cpu").space
    np.testing.assert_array_equal(np.asarray(space.dofmap), np.asarray(jops.space.dofmap))
    jw = np.asarray(jdec.dot_weights())
    tw = tun.holder_weights(np.asarray(space.dofmap), tables, space.ndofs)
    for q in range(ndev):
        auth = jdec.auth[q]
        order = np.argsort(jdec.map_idx[q][auth])
        np.testing.assert_array_equal(jdec.map_idx[q][auth][order],
                                      tun.rank_dofs(np.asarray(space.dofmap), tables, q,
                                                    space.ndofs))
        np.testing.assert_array_equal(jw[q][auth][order], tw[q])


def test_partition_mode_selection():
    """Cube-ish domains: the Morton partition replicates fewer rows and is
    picked; an elongated domain keeps the axis slabs (as in the JAX
    package, from the same tables)."""
    cube, _, degree, ndev, _ = _tables_case("cube", (4, 4, 4), 8)
    a = tun.partition_tables(cube, degree, ndev, "axis")
    m = tun.partition_tables(cube, degree, ndev, "morton")
    assert m["shared_payload"] < a["shared_payload"]
    assert tun.partition_tables(cube, degree, ndev)["partition_mode"] == "morton"
    lng, jlng, *_ = _tables_case("long", (16, 2, 2), 8)
    assert tun.partition_tables(lng, 2, 8)["partition_mode"] == "axis"
    assert jun.UnstructuredDecomposition(jlng, 2, 8, jnp.float64).partition_mode == "axis"


def _holder_weights(spec, degree, world):
    mesh = runs.make_mesh(spec)
    space = ft.SEMOperators(mesh, degree, torch.float64, "cpu").space
    tables = tun.partition_tables(mesh, degree, world)
    return tun.holder_weights(np.asarray(space.dofmap), tables, space.ndofs)


def test_unstructured_dirk_record(port):
    """The implicit recording: its CG counts, and each rank's dot weights
    1/(holders) of its DOFs."""
    got, ref, single = held(port, "dirk_record", keys=("u", "ys"))
    assert got["cg"] > 0 and got["cg_res2"] < 1e-10
    assert abs(got["cg"] - ref["cg"]) <= 2 and abs(got["cg"] - single["cg"]) <= 2
    want = _holder_weights(CASES["dirk_record"][1], 2, 4)
    for r, res in enumerate(port["dirk_record"]):
        np.testing.assert_array_equal(res["weights"], want[r])


def test_unstructured_rk_record(port):
    """Each sensor read at its lowest holder, on the true cells (Newton
    inverse map), reassembled on the host."""
    held(port, "rk_record", keys=("u", "v", "ys"))


@pytest.mark.slow
def test_unstructured_clustered_offnode_sensors(port_slow):
    held(port_slow, "clustered", keys=("u", "ys"))


def test_bowl_mesh_shards_via_unstructured(port):
    """A bowl-fitted mesh scales out through the unstructured split: the
    sharded run on ``as_unstructured(bowl)`` against the JAX split and the
    port's one device on the same numbering, and against the port's hybrid
    solve on the bowl mesh itself, through the DOF coordinates."""
    got, _, _ = held(port, "bowl", keys=("u",))
    spec = CASES["bowl"][1]
    hybrid = runs.make_model(dict(spec, as_unstructured=False), torch.device("cpu"))
    assert hybrid.ops.hybrid is not None
    u1 = hybrid.rk(0.0, spec["t_end"])[0].numpy()
    coords = runs.make_model(spec, torch.device("cpu")).ops.dof_coords()
    dist, perm = cKDTree(coords).query(hybrid.ops.dof_coords())
    assert dist.max() < 1e-12
    assert rel(got["u"][perm], u1) < 1e-11


def test_unstructured_refusals():
    """A mesh without the blocked numbering and an unknown partition mode
    are refused before any process group, in the JAX package's words."""
    for make in (lambda: tun.UnstructuredDecomposition(ft.create_rectangle((3, 3)), 2, 2,
                                                       torch.float64, device="cpu"),
                 lambda: jun.UnstructuredDecomposition(fus.create_rectangle((3, 3)), 2, 2,
                                                       jnp.float64)):
        with pytest.raises(ValueError, match="needs the blocked numbering"):
            make()
    umesh = ft.as_unstructured(ft.create_rectangle((3, 3)))
    jmesh = jas_unstructured(fus.create_rectangle((3, 3)))
    for make in (lambda: tun.UnstructuredDecomposition(umesh, 2, 2, torch.float64,
                                                       partition="hilbert", device="cpu"),
                 lambda: jun.UnstructuredDecomposition(jmesh, 2, 2, jnp.float64,
                                                       partition="hilbert")):
        with pytest.raises(ValueError, match="unknown partition mode 'hilbert'"):
            make()
