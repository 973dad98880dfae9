"""The port's grid decomposition (``fenicsxfus_tpu_torch/parallel/grid.py``,
gloo ranks on the CPU) against the JAX package's (``fenicsxfus_tpu/parallel/
grid.py`` on the suite's virtual CPU devices): the cases of
``tests/test_grid2d.py``, ``tests/test_grid_streamed.py`` and the grid cases
of ``tests/test_sharded_recording.py``, each run three ways in fp64 from the
same inputs (the JAX sharded solver on the same device grid, the port at the
same world size, the port's model on one device) and held at the JAX
suite's bounds: 1e-11 on u, v and the sensor traces, 1e-12 for the streamed
setup against the JAX streamed setup, the CG's worst iteration count within
2. The 4-device grids of the JAX suite, (4, 2) and (2, 4), run here as the
4-rank grids (2, 2), (4, 1) and (1, 4); the 3-axis (2, 2, 2) cases share
one launch of 8 ranks; the JAX suite's slow ones (the 3-axis sponge and
recording) are slow here too, with a launch of their own. The explicit
cases run 40 steps where the JAX suite runs 100 (the test-time budget),
from a pulse on the blocks' shared corner, so that every interface carries
a field from the first step. Also the padding faults of ``ROADMAP.md``
queue 3, the refusals, the per-axis exchange at world size 1 and against
the slab, and the dry run.

The ranks start through ``parallel.launch.spawn`` (one launch per world
size, ``runs.run_cases``); JAX's 8 virtual devices come from
``tests/conftest.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
from fenicsxfus_tpu.core.bowl import create_bowl_box as jbowl
from fenicsxfus_tpu.core.mesh import _structured as jstructured
from fenicsxfus_tpu.parallel import grid as jgrid
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.parallel import (
    GridDecomposition,
    UnstructuredDecomposition,
    dryrun,
    process_group,
    runs,
    spawn,
)

torch.set_num_threads(1)

LIN = (3, 1.0, 1.0, 10.0, 1.0, 1.0, 4, 4e-4)
DT_W = 0.4 / 9 / 1.5 / 9
DT_IMP = 0.4 / 8 / 1.5
AXIAL7 = np.stack([np.linspace(0.05, 0.95, 7), np.full(7, 0.2), np.full(7, 0.2)])
AXIAL5 = np.stack([np.linspace(0.05, 0.95, 5), np.full(5, 0.2), np.full(5, 0.2)])
_C0_W3D = 1.0 + 0.1 * np.random.default_rng(0).random(72)  # create_box((6, 4, 3)): 72 cells
W_REC = (3, 1.5, 1.0, 4e-3, 3.5, 10.0, 1.0, 1.5, 4, DT_W)
SPONGE = (3, 1.0, 1.0, 1e-2, 10.0, 1.0, 1.0)


def _rect(n, hi):
    return ("rectangle", n, (0.0, 0.0), hi)


def _box(n, hi):
    return ("box", n, (0.0, 0.0, 0.0), hi)


def _spec(name, dshape, mesh, model, args, run, t_end, **extra):
    return dict({"name": name, "mesh": mesh, "tag_L": 1.0, "model": model, "args": args,
                 "dtype": "float64", "run": run, "t_end": t_end, "decomp": "grid",
                 "dshape": dshape}, **extra)


REC_BOX = _box((9, 3, 3), (1.0, 0.4, 0.4))


def pulse(x, y):
    """A Gaussian pulse of u around the column (x, y) that the blocks share:
    every interface carries a field from the first step."""
    return {"u0": ([x, y], 0.2, 1.0)}


# 40 steps where the JAX suite takes 100 (the test-time budget), each
# explicit lattice case but the sponge from a pulse on the blocks' shared
# corner (the sponge starts at rest, as in the JAX suite, whose grid packs
# δ wrongly on padding cells: see test_nodal_coefficient_padding_cells_add_nothing)
CASES = {s["name"]: (int(np.prod(s["dshape"])), s) for s in [
    *[_spec(f"linear_2d_{a}x{b}", (a, b), _rect((8, 8), (1.0, 1.0)), "LinearSpectralExplicit",
            LIN, "rk", 0.016, **pulse(0.5, 0.5)) for a, b in ((2, 2), (4, 1), (1, 4))],
    _spec("uneven_both_axes", (2, 2), _rect((7, 5), (1.0, 0.8)), "LinearSpectralExplicit", LIN,
          "rk", 0.016, **pulse(4 / 7, 0.48)),
    _spec("westervelt_3d", (2, 2), _box((6, 4, 3), (1.0, 0.6, 0.4)), "WesterveltSpectralExplicit",
          (3, _C0_W3D, 1.0, 1e-4, 0.01, 10.0, 1.0, 1.0, 4, 4e-4), "rk", 0.016, k1_operands=True,
          **pulse(0.5, 0.3)),
    _spec("lossy_3d", (2, 2), _box((4, 4, 2), (1.0, 1.0, 0.3)), "LossySpectralExplicit",
          (3, 1.0, 1.0, 1e-3, 10.0, 1.0, 1.0, 4, 3e-4), "rk", 0.012, **pulse(0.5, 0.5)),
    _spec("implicit_2d", (2, 2), _rect((6, 5), (1.0, 0.8)), "LinearSpectralImplicit",
          (3, 1.0, 1.0, 10.0, 1.0, 1.0, 2, 1e-3), "dirk", 0.02),
    _spec("sponge_2d", (2, 2), _rect((8, 5), (1.0, 0.6)), "LinearSpectralSponge", SPONGE, "rk",
          0.016, kwargs={"sponge_start": 0.6}, dt=4e-4),
    _spec("streamed_westervelt_2d", (2, 2), _rect((7, 5), (1.0, 0.8)),
          "WesterveltSpectralExplicit", (3, "@sincos", 1.0, 1e-3, 0.02, 10.0, 1.0, 1.0, 4, 4e-4),
          "streamed", 0.016),
    _spec("streamed_implicit_2d", (2, 2), _rect((6, 5), (1.0, 0.8)), "LinearSpectralImplicit",
          (3, 1.0, 1.0, 10.0, 1.0, 1.0, 2, 1e-3), "streamed_dirk", 0.02),
    _spec("streamed_sponge_2d", (2, 2), _rect((8, 5), (1.0, 0.6)), "LinearSpectralSponge", SPONGE,
          "streamed", 0.016, kwargs={"sponge_start": 0.6}, dt=4e-4),
    _spec("rk_record", (2, 2), REC_BOX, "WesterveltSpectralExplicit", W_REC, "rk_record",
          40 * DT_W, points=AXIAL7),
    _spec("dirk_record", (2, 2), _box((8, 3, 3), (1.0, 0.4, 0.4)), "LinearSpectralImplicit",
          (2, 1.5, 1.0, 10.0, 1.0, 1.5, 2, DT_IMP), "dirk_record", 6 * DT_IMP, points=AXIAL5,
          kwargs={"cg_rtol": 1e-12}),
    _spec("nonzero_state", (2, 2), _box((8, 2, 2), (1.0, 0.4, 0.4)), "LinearSpectralExplicit",
          (3, 1.5, 1.0, 10.0, 1.0, 1.5, 4, 1e-3), "streamed_nonzero", 2e-3),
    # the one-axis grid and the slab on 9 cells over 4 ranks (rank 3 holds padding only)
    _spec("one_axis", (4,), _box((9, 2, 2), (1.0, 0.4, 0.4)), "WesterveltSpectralExplicit",
          W_REC, "rk", 20 * DT_W),
    dict(_spec("slab", (4,), _box((9, 2, 2), (1.0, 0.4, 0.4)), "WesterveltSpectralExplicit",
               W_REC, "rk", 20 * DT_W), decomp="slab"),
    # the sponge's δ with padding cells (7 cells: 4 + 3, and 2 + 2 + 2 + 1 on
    # the slab), a pulse where δ is nonzero on the padding cells' faces
    *[dict(_spec(f"sponge_pad_{d}", (2, 2) if d == "grid" else (4,), _rect((7, 5), (1.0, 0.8)),
                 "LinearSpectralSponge", SPONGE, "rk", 0.016, kwargs={"sponge_start": 0.3},
                 dt=4e-4, u0=([0.8, 0.5], 0.2, 1.0)), decomp=d) for d in ("grid", "slab")],
    _spec("streamed_sponge_pad", (2, 2), _rect((8, 5), (1.0, 0.6)), "LinearSpectralSponge",
          SPONGE, "streamed", 0.016, kwargs={"sponge_start": 0.0}, dt=4e-4),
    # a block of padding only that starts on the mesh's last plane (3 cells on 4;
    # c0 = 5: the wave crosses the 0.1-long mesh twice in 20 steps)
    *[dict(_spec(f"edge_{d}", (4, 1) if d == "grid" else (4,),
                 ("interval", (3,), (0.0,), (0.1,)) if d == "slab" else _rect((3, 2), (0.1, 0.1)),
                 "LinearSpectralImplicit", (3, 5.0, 1.0, 10.0, 1.0, 5.0, 2, 2e-3), "streamed_dirk",
                 0.04, tag_L=0.1), decomp=d) for d in ("grid", "slab")],
    # the 3-axis grid: one launch of 8 ranks
    _spec("linear_3d_2x2x2", (2, 2, 2), _box((4, 4, 4), (1.0, 1.0, 0.7)),
          "LinearSpectralExplicit", (2, 1.0, 1.0, 10.0, 1.0, 1.0, 4, 3e-4), "rk", 0.012,
          u0=([0.5, 0.5, 0.35], 0.2, 1.0)),
    _spec("streamed_3axis", (2, 2, 2), _box((4, 4, 3), (1.0, 0.8, 0.6)),
          "LinearSpectralExplicit", (2, 1.0, 1.1, 8.0, 1.0, 1.0, 4, 6e-4), "streamed", 0.02),
]}
# the JAX suite's slow (2, 2, 2) cases, slow here too: a launch of their own
SLOW = {s["name"]: (8, s) for s in [
    _spec("sponge_3d_2x2x2", (2, 2, 2), _box((4, 4, 3), (1.0, 0.6, 0.5)), "LinearSpectralSponge",
          (2, 1.0, 1.0, 1e-2, 8.0, 1.0, 1.0), "rk", 0.02, kwargs={"sponge_start": 0.6},
          dt=6e-4),
    _spec("rk_record_2x2x2", (2, 2, 2), REC_BOX, "WesterveltSpectralExplicit", W_REC,
          "rk_record", 40 * DT_W, points=AXIAL7),
]}


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


def held_single(port, name, tol=1e-11):
    """The port at world size n against the port's one device on u and v;
    every rank holds the same global fields."""
    got = port[name][0]
    for other in port[name][1:]:
        assert np.array_equal(other["u"], got["u"]) and np.array_equal(other["v"], got["v"])
    single = runs.run_single(CASES[name][1], torch.device("cpu"))
    for key in ("u", "v"):
        assert rel(got[key], single[key]) < tol, (name, key, rel(got[key], single[key]))


def _tag(mesh):
    return fus.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1.0 - 1e-12})


def jax_model(spec, mesh=None):
    if mesh is None:
        _, n, lo, hi = spec["mesh"]
        mesh = _tag(jstructured(tuple(n), tuple(lo), tuple(hi)))
    args = [runs.sincos(mesh) if isinstance(a, str) else a for a in spec["args"]]
    m = getattr(fus, spec["model"])(mesh, None, *args, dtype=jnp.float64,
                                    **spec.get("kwargs", {}))
    if "dt" in spec:
        m.dt = spec["dt"]
        m._build()
    m.init()
    if "u0" in spec:  # the pulse of runs.make_model
        center, width, amp = spec["u0"]
        x = np.asarray(m.ops.dof_coords())[:, : len(center)]
        m.u_n = jnp.asarray(amp * np.exp(-((x - np.asarray(center)) ** 2).sum(axis=1) / width**2))
    return m


def jax_run(spec) -> dict:
    """The JAX grid-sharded run of a case on the same device grid."""
    run, t_end, dshape = spec["run"], spec["t_end"], tuple(spec["dshape"])
    if run.startswith("streamed"):
        _, n, lo, hi = spec["mesh"]
        sol = jgrid.build_sharded_grid(lambda lm: jax_model(spec, _tag(lm)), tuple(n), lo, hi,
                                       spec["args"][0], dshape, jnp.float64,
                                       implicit=run == "streamed_dirk")
        (sol.dirk if run == "streamed_dirk" else sol.rk)(0.0, t_end)
        u, v = sol.global_result()
        return {"u": np.asarray(u), "v": np.asarray(v)}
    m = jax_model(spec)
    implicit = run.startswith("dirk")
    sol = (jgrid.ShardedImplicitSolverND if implicit else jgrid.ShardedExplicitSolver2D)(m, dshape)
    out = {}
    if run.endswith("_record"):
        u, v, _, out["times"], out["ys"] = getattr(sol, run)(0.0, t_end, spec["points"])
        out["located"] = sol.dec.locate_sensors(spec["points"])
    else:
        u, v, _ = getattr(sol, run)(0.0, t_end)
    out.update(u=np.asarray(u), v=np.asarray(v), sol=sol)
    if implicit:
        out["cg"] = m.cg_stats["max_iterations"]
    return out


def rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(np.max(np.abs(b)), 1e-300))


def held(port, name, tol=1e-11, tol_jax=None, keys=("u", "v")):
    """The port at world size n against the JAX grid-sharded run on the same
    device grid (``tol_jax``, default ``tol``) and the port's one device
    (``tol``), on ``keys``; every rank holds the same global fields."""
    world, spec = {**CASES, **SLOW}[name]
    got = port[name][0]
    for other in port[name][1:]:
        for key in keys:
            assert np.array_equal(other[key], got[key]), (name, key)
    ref = jax_run(spec)
    single = runs.run_single(spec, torch.device("cpu"))
    for key in keys:
        assert rel(got[key], ref[key]) < (tol_jax or tol), (name, key, "jax", rel(got[key], ref[key]))
        assert rel(got[key], single[key]) < tol, (name, key, "single", rel(got[key], single[key]))
    if "times" in ref:
        np.testing.assert_allclose(got["times"], ref["times"], rtol=0, atol=1e-14)
        for a, b in zip(got["located"], ref["located"]):
            np.testing.assert_array_equal(a, b)
    return got, ref, single


@pytest.mark.parametrize("dshape", ["2x2", "4x1", "1x4"])
def test_grid2d_linear_2d(port, dshape):
    """The corner columns of a (2, 2) grid are shared by four ranks; the
    sequential two-axis exchange routes the diagonal sums."""
    held(port, f"linear_2d_{dshape}")


def test_grid2d_uneven_both_axes(port):
    held(port, "uneven_both_axes")


def test_grid2d_westervelt_3d_heterogeneous(port):
    held(port, "westervelt_3d")


def test_grid2d_lossy_3d(port):
    held(port, "lossy_3d")


def test_grid3d_linear_3d(port):
    """(2, 2, 2): corner points shared by 8 ranks complete through three
    sequential exchanges."""
    held(port, "linear_3d_2x2x2")


def test_gridnd_implicit_2d(port):
    """The SDIRK CG with replica-weighted dots reduced over the ranks; its
    dot weights are the JAX package's, rank by rank."""
    got, ref, single = held(port, "implicit_2d")
    assert 1 <= got["cg"] < 2000
    assert abs(got["cg"] - ref["cg"]) <= 2 and abs(got["cg"] - single["cg"]) <= 2
    jw = np.asarray(ref["sol"].weights)
    for r, res in enumerate(port["implicit_2d"]):
        np.testing.assert_array_equal(res["weights"], jw[r])


def test_grid2d_sponge_2d(port):
    """The nodal δ coefficient packed per block, zeros on padding rows."""
    held(port, "sponge_2d")


@pytest.mark.slow
def test_grid3d_sponge_3d(port_slow):
    held(port_slow, "sponge_3d_2x2x2")


def test_streamed_grid_westervelt_2d_uneven(port):
    """``build_sharded_grid`` (each rank builds its block alone) against the
    JAX streamed setup (1e-12) and the port's one device."""
    held(port, "streamed_westervelt_2d", tol=1e-12)


def test_streamed_grid_linear_3d_3axis(port):
    held(port, "streamed_3axis", tol=1e-12)


def test_streamed_grid_implicit_2d(port):
    held(port, "streamed_implicit_2d", tol_jax=1e-12)


def test_streamed_grid_sponge_2d(port):
    held(port, "streamed_sponge_2d", tol_jax=1e-12)


def test_grid2d_rk_record(port):
    """Axial sensors off the nodes, recorded by their ranks and reassembled;
    each sensor's nearest node located as the JAX package locates it."""
    held(port, "rk_record", keys=("u", "v", "ys"))


@pytest.mark.slow
def test_grid3d_rk_record(port_slow):
    held(port_slow, "rk_record_2x2x2", keys=("u", "ys"))


def test_grid2d_dirk_record(port):
    got, ref, single = held(port, "dirk_record", keys=("u", "ys"))
    assert got["cg"] > 0 and got["cg_res2"] < 1e-10
    assert abs(got["cg"] - ref["cg"]) <= 2 and abs(got["cg"] - single["cg"]) <= 2


def test_streamed_grid_rejects_nonzero_initial_state(port):
    for r in port["nonzero_state"]:
        assert r["error"] is not None and "zero fields" in r["error"]


def test_k1_operands_are_the_ranks_own(port):
    """Each rank's K1 operands (its block's lattice and packed coefficients,
    padding cells 0) applied to its block of a global pair of fields: added
    block by block, the shared planes summed, they give the single device's
    stiffness."""
    from fenicsxfus_tpu_torch.ops.stiffness import stiffness_plain

    spec = CASES["westervelt_3d"][1]
    model = runs.make_model(spec, torch.device("cpu"))
    G, p = model.ops.gdims, model.ops.degree
    rng = np.random.default_rng(17)
    xs = [torch.as_tensor(rng.standard_normal(G)) for _ in range(2)]
    y = stiffness_plain(xs, [model.consts[k] for k in type(model).STIFF_KEYS], p)
    ops = [r["k1_operands"] for r in port["westervelt_3d"]]
    L0, L1 = ops[0]["gdims"][:2]
    assert (L0, L1) == (3 * p + 1, 2 * p + 1)  # 6 x 4 cells on a (2, 2) grid
    padded = [torch.zeros((2 * (L0 - 1) + 1, 2 * (L1 - 1) + 1, G[2]), dtype=torch.float64)
              for _ in xs]
    for x, xp in zip(xs, padded):
        xp[: G[0], : G[1]] = x
    total = torch.zeros_like(padded[0])
    for r, o in enumerate(ops):
        i, j = np.unravel_index(r, (2, 2))
        blk = (slice(i * (L0 - 1), i * (L0 - 1) + L0), slice(j * (L1 - 1), j * (L1 - 1) + L1))
        total[blk] += stiffness_plain([x[blk] for x in padded], o["F"], o["degree"])
    scale = float(y.abs().max())
    assert float((total[: G[0], : G[1]] - y).abs().max()) <= 1e-12 * scale


def test_slab_and_one_axis_grid_same_bits(port):
    """The slab's exchange and the grid's per-axis exchange are one
    transport: the (4,) grid and the slab give the same bits, padding rank
    included."""
    for a, b in zip(port["slab"], port["one_axis"]):
        assert np.array_equal(a["u"], b["u"]) and np.array_equal(a["v"], b["v"])
        assert a["k1"] == b["k1"]
    held_single(port, "one_axis")


@pytest.mark.parametrize("name", ["sponge_pad_grid", "sponge_pad_slab", "streamed_sponge_pad"])
def test_nodal_coefficient_padding_cells_add_nothing(port, name):
    """A padding cell shares a face with the last true cells, where the
    sponge's nodal δ is nonzero: its packed scales must be zero (the true
    sub-lattice's scales, ``_nodal_scales``), not only its nodal values.
    Held against the one device; the JAX package's grid and slab zero the
    nodal values only and miss it (1.1e-3 and 7.0e-4 from their one device
    on the first two cases, ``ROADMAP.md`` queue 3)."""
    held_single(port, name)


@pytest.mark.parametrize("decomp", ["slab", "grid"])
def test_streamed_padding_only_block_keeps_the_last_plane(port, decomp):
    """3 cells on 4 ranks: the last block holds no cell but starts on the
    mesh's last plane, a true replica; the streamed setup pads its
    diagonals with 1 only past the mesh, so the CG's dots and the gather
    see the assembled value (the JAX package's streamed setups pad the
    whole block: 3.9e-10 and 0.25 from the one device)."""
    held_single(port, f"edge_{decomp}")


def _bowl():
    return jbowl((6, 6, 6), (0, 0, 0), (1.0, 0.9, 0.9), 0.7, 0.35)[0]


def test_grid_rejects_deformed_mesh_and_extra_axes():
    """The grid refuses a deformed (bowl-fitted) lattice and more grid axes
    than mesh axes, before it needs a process group, in the JAX package's
    words."""
    jmesh = _bowl()
    tmesh = ft.create_bowl_box((6, 6, 6), (0, 0, 0), (1.0, 0.9, 0.9), 0.7, 0.35)[0]
    for make in (lambda: GridDecomposition(tmesh, 3, (2,), torch.float64, "cpu"),
                 lambda: jgrid.GridDecomposition(jmesh, 3, (2,), jnp.float64)):
        with pytest.raises(ValueError, match="deformed"):
            make()
    rect, jrect = ft.create_rectangle((4, 4)), fus.create_rectangle((4, 4))
    for make in (lambda: GridDecomposition(rect, 2, (2, 2, 2), torch.float64, "cpu"),
                 lambda: jgrid.GridDecomposition(jrect, 2, (2, 2, 2), jnp.float64)):
        with pytest.raises(ValueError, match="more device-mesh axes than mesh axes"):
            make()


def test_complete_is_identity_at_world_size_1():
    """At world size 1 the grid's and the unstructured split's ``complete``
    return their argument, and the grid's local lattice is the mesh's."""
    with process_group("gloo"):
        dec = GridDecomposition(ft.create_box((3, 2, 2)), 2, (1, 1), torch.float64, "cpu")
        y = torch.arange(float(dec.local_ndofs), dtype=torch.float64)
        assert dec.ops.complete(y) is y and dec.local_gdims == (7, 5, 5)
        mesh = ft.as_unstructured(ft.create_rectangle((3, 2)))
        udec = UnstructuredDecomposition(mesh, 2, None, torch.float64, device="cpu")
        y = torch.ones(udec.local_ndofs, dtype=torch.float64)
        assert udec.ops.complete(y) is y and udec.shared_rows == 0
        assert np.array_equal(udec.l2g, np.arange(udec.ndofs))


def test_dryrun_multichip_gloo():
    """The dry run at 4 gloo ranks on the CPU: the uneven slab with
    recording, the implicit CG, the sponge, the (2, 2) grid, the scrambled
    unstructured mesh with recording and the bowl through the slab; every
    field finite on every rank, each rank its own part."""
    res = dryrun.dryrun_multichip(4, "gloo", "cpu")
    assert len(res) == 4
    for rank in res:
        assert {"slab_record", "implicit_record", "sponge", "grid 2x2", "unstructured_record",
                "bowl slab"} <= set(rank)
        assert all(r["finite"] for r in rank.values())
        assert rank["slab_record"]["sensors"][1] == 5
    assert sum(r["unstructured"]["local_cells"] for r in res) == 9 * 2 * 2
