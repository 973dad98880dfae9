"""The port's slab decomposition (``fenicsxfus_tpu_torch/parallel/slab.py``,
gloo ranks on the CPU) against the JAX package's (``fenicsxfus_tpu/parallel/
slab.py`` on the suite's virtual CPU devices): the cases of
``tests/test_sharding.py`` with at most 4 ranks, each run three ways in
fp64 from the same inputs (the JAX sharded solver at ndev = n, the port at
world size n, the port's model on one device) and held at the JAX suite's
bounds (1e-11 on u and v; 1e-12 for the streamed setup against the JAX
streamed setup). Also the hooks the slab needs: ``cg_solve``'s ``dot``,
``SEMOperators.complete`` and the models' shard attributes.

The port's ranks start through ``parallel.launch.spawn`` (one launch per
world size for the whole file, ``runs.run_cases``); JAX's 8 virtual devices
come from ``tests/conftest.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
from fenicsxfus_tpu.ops.cg import cg_solve as jcg_solve
from fenicsxfus_tpu.parallel import slab as jslab
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.ops.cg import cg_solve
from fenicsxfus_tpu_torch.parallel import runs, spawn

torch.set_num_threads(1)


def _case(name, world, mesh, model, args, run, t_end, **extra):
    return name, world, dict(name=name, mesh=mesh, tag_L=1.0, model=model, args=args,
                             dtype="float64", run=run, t_end=t_end, **extra)


def _interval(n):
    return ("interval", (n,), (0.0,), (1.0,))


LIN_1D = (4, 1.0, 1.0, 10.0, 1.0, 1.0, 4, 5e-4)
UNEVEN = (3, 1.0, 1.0, 10.0, 1.0, 1.0, 4, 5e-4)
STREAM_1D = (3, 1.2, 0.9, 10.0, 1.0, 1.2, 4, 5e-4)
IMP_STREAM = (3, 1.0, 1.0, 10.0, 1.0, 1.0, 2, 2e-3)
W_STREAM = (3, "@sincos", 1.0, 1e-3, 0.02, 10.0, 1.0, 1.0, 4, 4e-4)
_C0_W3D = 1.0 + 0.1 * np.random.default_rng(0).random(81)  # create_box((9, 3, 3)): 81 cells

CASES = dict((n, (w, s)) for n, w, s in [
    _case("linear_1d_2", 2, _interval(16), "LinearSpectralExplicit", LIN_1D, "rk", 0.05),
    _case("linear_1d_4", 4, _interval(16), "LinearSpectralExplicit", LIN_1D, "rk", 0.05),
    _case("linear_2d", 4, ("rectangle", (8, 5), (0, 0), (1.0, 0.5)), "LinearSpectralExplicit",
          (3, 1.5, 1.2, 10.0, 1.0, 1.5, 4, 4e-4), "rk", 0.05),
    # 9 cells on 2 ranks: uneven (the m0 = 1 padding of the nonlinear mass divide)
    _case("westervelt_3d", 2, ("box", (9, 3, 3), (0, 0, 0), (1.0, 0.4, 0.4)),
          "WesterveltSpectralExplicit",
          (3, _C0_W3D, 1.0, 1e-4, 0.01, 10.0, 1.0, 1.0, 4, 4e-4), "rk", 0.05,
          k1_operands=True),
    _case("lossy_2d", 4, ("rectangle", (8, 4), (0, 0), (1.0, 0.5)), "LossySpectralExplicit",
          (4, 1.0, 1.0, 1e-3, 10.0, 1.0, 1.0, 4, 3e-4), "rk", 0.05),
    # uneven partitions; 5 and 3 cells on 4 ranks leave rank 3 only padding
    _case("uneven_9_4", 4, _interval(9), "LinearSpectralExplicit", UNEVEN, "rk", 0.05),
    _case("uneven_5_4", 4, _interval(5), "LinearSpectralExplicit", UNEVEN, "rk", 0.05),
    _case("uneven_3_4", 4, _interval(3), "LinearSpectralExplicit", UNEVEN, "rk", 0.05),
    _case("implicit_linear_1d", 2, _interval(16), "LinearSpectralImplicit",
          (4, 1.0, 1.0, 10.0, 1.0, 1.0, 2, 1e-3), "dirk", 0.02),
    _case("implicit_lossy_2d_uneven", 4, ("rectangle", (7, 4), (0, 0), (1.0, 0.5)),
          "LossySpectralImplicit", (3, 1.0, 1.0, 1e-3, 10.0, 1.0, 1.0, 2, 1e-3), "dirk", 0.02),
    # the nodal δ(x) coefficient, packed per rank from raw_nodal
    _case("sponge_2d", 4, ("rectangle", (8, 4), (0, 0), (1.0, 0.5)), "LinearSpectralSponge",
          (3, 1.0, 1.0, 1e-2, 10.0, 1.0, 1.0), "rk", 0.05, kwargs={"sponge_start": 0.6},
          dt=4e-4),
    _case("streamed_16_4", 4, _interval(16), "LinearSpectralExplicit", STREAM_1D, "streamed",
          0.04),
    _case("streamed_13_4", 4, _interval(13), "LinearSpectralExplicit", STREAM_1D, "streamed",
          0.04),
    _case("streamed_westervelt_2d", 4, ("rectangle", (7, 3), (0.0, 0.0), (1.0, 0.4)),
          "WesterveltSpectralExplicit", W_STREAM, "streamed", 0.03),
    _case("streamed_implicit", 4, _interval(10), "LinearSpectralImplicit", IMP_STREAM,
          "streamed_dirk", 0.02),
    _case("cg_stats", 4, _interval(8), "LinearSpectralImplicit",
          (3, 1.0, 1.0, 10.0, 1.0, 1.0, 2, 2e-3), "dirk", 0.01),
])


@pytest.fixture(scope="module")
def port():
    """Every case's port run on every rank: {name: [rank 0's result, ...]};
    one gloo launch per world size."""
    out = {}
    for world in sorted({w for w, _ in CASES.values()}):
        names = [n for n, (w, _) in CASES.items() if w == world]
        per_rank = spawn(runs.run_cases, world, "gloo", "cpu",
                         args=([CASES[n][1] for n in names],))
        for i, name in enumerate(names):
            out[name] = [r[i] for r in per_rank]
    return out


def jax_mesh(spec):
    kind, n, lo, hi = spec["mesh"]
    from fenicsxfus_tpu.core.mesh import _structured

    return fus.tag_boundaries(_structured(tuple(n), tuple(lo), tuple(hi)),
                              {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1.0 - 1e-12})


def jax_model(spec, mesh=None):
    mesh = jax_mesh(spec) if mesh is None else mesh
    args = [runs.sincos(mesh) if isinstance(a, str) else a for a in spec["args"]]
    m = getattr(fus, spec["model"])(mesh, None, *args, dtype=jnp.float64,
                                    **spec.get("kwargs", {}))
    if "dt" in spec:
        m.dt = spec["dt"]
        m._build()
    m.init()
    return m


def jax_run(spec, ndev):
    """The JAX sharded run of a case: (u, v, cg iterations or None)."""
    run, t_end = spec["run"], spec["t_end"]
    if run.startswith("streamed"):
        kind, n, lo, hi = spec["mesh"]

        def factory(local_mesh):
            fus.tag_boundaries(local_mesh, {1: lambda x: x[0] < 1e-12,
                                            2: lambda x: x[0] > 1.0 - 1e-12})
            return jax_model(spec, local_mesh)

        sol = jslab.build_sharded(factory, tuple(n), lo, hi, spec["args"][0], ndev, jnp.float64,
                                  implicit=run == "streamed_dirk")
        (sol.dirk if run == "streamed_dirk" else sol.rk)(0.0, t_end)
        u, v = sol.global_result()
        return np.asarray(u), np.asarray(v), None
    m = jax_model(spec)
    if run == "dirk":
        u, v, _ = jslab.ShardedImplicitSolver(m, ndev=ndev).dirk(0.0, t_end)
        return np.asarray(u), np.asarray(v), m.cg_stats["max_iterations"]
    u, v, _ = jslab.ShardedExplicitSolver(m, ndev=ndev).rk(0.0, t_end)
    return np.asarray(u), np.asarray(v), None


def rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(np.max(np.abs(b)), 1e-300))


def held(port, name, tol=1e-11, tol_jax=None):
    """The port's run at world size n against the JAX sharded run at
    ndev = n (``tol_jax``, default ``tol``) and the port's single device
    (``tol``); every rank holds the same global fields."""
    world, spec = CASES[name]
    ranks = port[name]
    got = ranks[0]
    for other in ranks[1:]:
        assert np.array_equal(other["u"], got["u"]) and np.array_equal(other["v"], got["v"])
    ju, jv, jcg = jax_run(spec, world)
    single = runs.run_single(spec, torch.device("cpu"))
    for key, ref in (("u", ju), ("v", jv)):
        assert rel(got[key], ref) < (tol_jax or tol), (name, key, "jax", rel(got[key], ref))
        assert rel(got[key], single[key]) < tol, (name, key, "single", rel(got[key], single[key]))
    return got, jcg, single


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_linear_1d(port, ndev):
    held(port, f"linear_1d_{ndev}")


def test_sharded_linear_2d(port):
    held(port, "linear_2d")


def test_sharded_westervelt_3d(port):
    held(port, "westervelt_3d")


def test_k1_operands_are_the_ranks_own(port):
    """Each rank's K1 operands (``k1_operands``: its local lattice and packed
    coefficients, the last rank's with its padding cell) applied to its slab
    of a global pair of fields: added plane by plane, with the interface
    plane's two partial sums, they give the single device's stiffness."""
    from fenicsxfus_tpu_torch.ops.stiffness import stiffness_plain

    model = runs.make_model(CASES["westervelt_3d"][1], torch.device("cpu"))
    G, p = model.ops.gdims, model.ops.degree
    rng = np.random.default_rng(16)
    xs = [torch.as_tensor(rng.standard_normal(G)) for _ in range(2)]
    y = stiffness_plain(xs, [model.consts[k] for k in type(model).STIFF_KEYS], p)
    ops = [r["k1_operands"] for r in port["westervelt_3d"]]
    Lx = ops[0]["gdims"][0]
    assert Lx == 5 * p + 1  # 9 cells on 2 ranks: 5 each, the last with a padding cell
    assert all(o["gdims"] == (Lx,) + tuple(G[1:]) and len(o["F"]) == 2 for o in ops)
    padded = [torch.cat([x, x.new_zeros((2 * (Lx - 1) + 1 - G[0],) + tuple(G[1:]))]) for x in xs]
    total = torch.zeros_like(padded[0])
    for r, o in enumerate(ops):
        rows = slice(r * (Lx - 1), r * (Lx - 1) + Lx)
        total[rows] += stiffness_plain([x[rows] for x in padded], o["F"], o["degree"])
    scale = float(y.abs().max())
    assert float((total[: G[0]] - y).abs().max()) <= 1e-12 * scale
    assert float(total[G[0]:].abs().max()) == 0.0


def test_sharded_lossy_2d(port):
    held(port, "lossy_2d")


@pytest.mark.parametrize("ncells", [9, 5, 3])
def test_sharded_uneven_partition(port, ncells):
    """Cell counts that do not divide the world size run with inert padding
    cells on the last slabs; with 5 or 3 cells on 4 ranks, rank 3 holds
    only padding."""
    held(port, f"uneven_{ncells}_4")


def test_sharded_implicit_linear_1d(port):
    got, jcg, single = held(port, "implicit_linear_1d")
    assert 1 <= got["cg"] < 2000 and abs(got["cg"] - jcg) <= 2


def test_sharded_implicit_lossy_2d_uneven(port):
    got, jcg, single = held(port, "implicit_lossy_2d_uneven")
    assert 1 <= got["cg"] < 2000 and abs(got["cg"] - jcg) <= 2


def test_sharded_sponge_2d(port):
    held(port, "sponge_2d")


@pytest.mark.parametrize("ncells", [16, 13])
def test_streamed_setup_matches_global(port, ncells):
    """``build_sharded`` (each rank builds its slab alone) against the JAX
    streamed setup (1e-12) and the port's single device (1e-11)."""
    held(port, f"streamed_{ncells}_4", tol_jax=1e-12)


def test_streamed_setup_westervelt_2d_uneven(port):
    held(port, "streamed_westervelt_2d", tol_jax=1e-12)


def test_streamed_setup_implicit(port):
    held(port, "streamed_implicit")


def test_sharded_dirk_cg_stats_match_single_device(port):
    """The sharded CG's worst iteration count within 2 of the single
    device's (the reduced dots sum in another order)."""
    got, jcg, single = held(port, "cg_stats")
    assert abs(got["cg"] - single["cg"]) <= 2 and abs(got["cg"] - jcg) <= 2


# ----------------------------------------------------------------- the hooks


def test_cg_default_dot_is_torch_dot():
    """``cg_solve(dot=None)`` takes the same iterates and count as passing
    ``torch.dot`` itself, bit for bit; a weighted dot solves the same
    system."""
    rng = np.random.default_rng(3)
    n = 40
    q = rng.standard_normal((n, n))
    A = torch.as_tensor(q @ q.T + n * np.eye(n))
    b = torch.as_tensor(rng.standard_normal(n))
    dinv = 1.0 / torch.diagonal(A)
    x0 = torch.zeros(n, dtype=torch.float64)
    x1, (it1, r1) = cg_solve(lambda x: A @ x, b, x0, dinv, rtol=1e-12)
    x2, (it2, r2) = cg_solve(lambda x: A @ x, b, x0, dinv, rtol=1e-12, dot=torch.dot)
    assert it1 == it2 and torch.equal(x1, x2) and torch.equal(r1, r2)
    xj, (itj, _) = jcg_solve(lambda x: jnp.asarray(A.numpy()) @ x, jnp.asarray(b.numpy()),
                             jnp.zeros(n), jnp.asarray(dinv.numpy()), rtol=1e-12)
    assert it1 == int(itj) and rel(x1.numpy(), np.asarray(xj)) < 1e-12
    w = torch.full((n,), 0.5, dtype=torch.float64)
    x3, _ = cg_solve(lambda x: A @ x, b, x0, dinv, rtol=1e-12,
                     dot=lambda a, c: torch.sum(w * a * c))
    assert rel(x3.numpy(), x1.numpy()) < 1e-10


def test_complete_is_identity_on_one_device():
    """On one device ``complete`` returns its argument, and the stiffness
    applies return what they assembled (the lattice K1 path, 1D/2D
    ``apply_scaled``, the nodal apply, the general fold)."""
    ops = ft.SEMOperators(ft.create_box((2, 2, 3)), 2, dtype=torch.float64, device="cpu")
    y = torch.arange(5.0)
    assert ops.complete(y) is y
    seen = []
    ops.complete = lambda t: seen.append(t) or t
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(ops.ndofs))
    ops.stiffness_apply([x], [ops.stiff_coeff(1.3)])
    ops.stiffness_apply_nodal([x], [np.ones(ops.ndofs)])
    gen = ft.SEMOperators(ft.as_unstructured(ft.create_rectangle((2, 3))), 2,
                          dtype=torch.float64, device="cpu")
    gen.complete = lambda t: seen.append(t) or t
    gen.stiffness_apply([torch.ones(gen.ndofs, dtype=torch.float64)], [1.0])
    assert len(seen) == 3


def _hook_models():
    t, j = ft.create_box((3, 2, 2)), fus.create_box((3, 2, 2))
    for m in (t, j):
        (ft if m is t else fus).tag_boundaries(m, {1: lambda x: x[0] < 1e-12,
                                                    2: lambda x: x[0] > 1 - 1e-12})
    c0 = 1.0 + 0.1 * np.arange(12) / 12
    base = (2, c0, 1.2)
    return {
        "LinearSpectralExplicit": (base + (10.0, 1.0, 1.0, 4, 1e-3), {}),
        "LinearSpectralImplicit": (base + (10.0, 1.0, 1.0, 2, 1e-3), {}),
        "LossySpectralExplicit": (base + (1e-3, 10.0, 1.0, 1.0, 4, 1e-3), {}),
        "LossySpectralImplicit": (base + (1e-3, 10.0, 1.0, 1.0, 2, 1e-3), {}),
        "WesterveltSpectralExplicit": (base + (1e-3, 3.5, 10.0, 1.0, 1.0, 4, 1e-3), {}),
        "WesterveltSpectralFocused": (base + (1e-3, 3.5, 10.0, 1.0, 1.0, 4, 1e-3, 0.2, 0.6),
                                      {}),
        "LinearSpectralS2": ((2, c0, 1.2, 10.0, 1.0, 1.0), {}),
        "LinearSpectralSponge": ((2, 1.0, 1.2, 1e-2, 10.0, 1.0, 1.0), {"sponge_start": 0.5}),
    }, t, j


@pytest.mark.parametrize("name", sorted(_hook_models()[0]))
def test_model_shard_hooks_match_jax(name):
    """Each model's ``STIFF_KEYS``, ``SHARD_INV_KEYS``, ``PAD_ONE_KEYS``,
    ``NODAL_STIFF_KEYS`` and its ``raw_stiff``/``raw_nodal`` (float64 on
    the host) equal the JAX model's."""
    cases, tmesh, jmesh = _hook_models()
    args, kw = cases[name]
    tm = getattr(ft, name)(tmesh, None, *args, dtype=torch.float64, device="cpu", **kw)
    jm = getattr(fus, name)(jmesh, None, *args, dtype=jnp.float64, **kw)
    for attr in ("STIFF_KEYS", "SHARD_INV_KEYS", "PAD_ONE_KEYS", "NODAL_STIFF_KEYS"):
        assert getattr(type(tm), attr, ()) == getattr(type(jm), attr, ()), attr
    for attr in ("raw_stiff", "raw_nodal"):
        a, b = getattr(tm, attr, None), getattr(jm, attr, None)
        assert (a is None) == (b is None), attr
        if a is not None:
            assert sorted(a) == sorted(b)
            for k in a:
                assert np.asarray(a[k]).dtype == np.float64
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
