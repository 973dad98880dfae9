"""The SDIRK implicit path of the PyTorch port against the JAX package, fp64
on the CPU:

* ``dirk_tables`` equal bit for bit, orders 1-4;
* ``cg_solve`` on an SPD lattice operator (M + τ²K of a 1D, 2D and 3D
  lattice) stops at the JAX ``while_loop``'s iteration, x within 1e-12;
* ``SEMOperators.stiffness_diag`` within 1e-13 on 1D/2D/3D uniform lattices
  (constant and DG-0 coefficients) and on a small bowl mesh (the hybrid
  branch), where it also equals the JAX general per-cell path
  (``FUS_HYBRID=0``) to 1e-12;
* ``LinearSpectralImplicit``/``LossySpectralImplicit`` in 1D, 2D
  (``tests/test_grid2d.py:108-126``'s ``create_rectangle((6,5))`` p=3 order
  2 and ``tests/test_sharding.py:152-159``'s lossy ``create_rectangle((7,
  4))``), on a small 3D box and on a bowl mesh: u and v after 12 steps
  within 1e-10 relative and equal ``cg_stats["max_iterations"]``; the host
  consts carried across by ``convert.py`` to 1e-13;
* ``dirk_record`` against the JAX ``dirk_record`` and against ``dirk``;
* the reference's implicit accuracy gates of ``tests/test_models_1d.py``
  at the JAX package's tier-1 pairs and tolerances (linear (3,8), (4,4)
  < 0.05; lossy (4,4) < 1e-2; the same domain, tend and dt).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
from fenicsxfus_tpu.models.common import dirk_tables as jax_dirk_tables
from fenicsxfus_tpu.ops.cg import cg_solve as jax_cg_solve
from fenicsxfus_tpu.ops.operators import SEMOperators as JaxOps
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.analysis.analytical import damped_planewave, planewave
from fenicsxfus_tpu_torch.analysis.error import relative_l2_error
from fenicsxfus_tpu_torch.convert import consts_from_numpy, state_from_numpy
from fenicsxfus_tpu_torch.models.common import dirk_tables
from fenicsxfus_tpu_torch.ops.cg import cg_solve
from fenicsxfus_tpu_torch.ops.operators import SEMOperators

torch.set_num_threads(1)


def _rel(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _ends(mod, mesh, L):
    mod.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    return mesh


# (mesh function name, its arguments, domain length along x)
LATTICES = {
    "1d": ("create_interval", (9, 0.0, 1.0), 1.0),
    "2d": ("create_rectangle", ((6, 5), (0, 0), (1.0, 0.8)), 1.0),
    "3d": ("create_box", ((4, 3, 3), (0, 0, 0), (1.0, 0.6, 0.7)), 1.0),
}
# create_bowl_box arguments of tests/test_hybrid.py::_bowl_mesh_shallow
BOWL = ((16, 7, 7), (0, 0, 0), (1.0, 0.9, 0.9), 0.9, 0.25)
BOWL_KW = dict(blend=0.08, lateral_hold=0.08)


def _meshes(case):
    """The same tagged mesh built by each package: (port, JAX)."""
    if case == "bowl":
        return tuple(_ends(mod, mod.create_bowl_box(*BOWL, **BOWL_KW)[0], 1.0)
                     for mod in (ft, fus))
    name, args, L = LATTICES[case]
    return tuple(_ends(mod, getattr(mod, name)(*args), L) for mod in (ft, fus))


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_dirk_tables_match_jax(order):
    assert dirk_tables(order) == jax_dirk_tables(order)
    for table in dirk_tables(order):
        flat = [x for row in table for x in (row if isinstance(row, tuple) else (row,))]
        assert all(type(x) is float for x in flat)
    with pytest.raises(ValueError):
        dirk_tables(5)


@pytest.mark.parametrize("maxiter", [2000, 3])
@pytest.mark.parametrize("case", sorted(LATTICES))
def test_cg_solve_matches_jax(case, maxiter):
    """PCG on A = M + τ²K (an SPD lattice operator) with a Jacobi
    preconditioner from a nonzero start: the same iteration count (also when
    ``maxiter`` caps it), x within 1e-12."""
    tmesh, jmesh = _meshes(case)
    p, tau = 3, 0.02
    rng = np.random.default_rng(3)
    coeff = rng.uniform(0.5, 2.0, tmesh.num_cells)
    tops = SEMOperators(tmesh, p, dtype=torch.float64, device="cpu")
    jops = JaxOps(jmesh, p, dtype=jnp.float64)
    m = tops.assemble_diag(coeff)
    dinv = 1.0 / (m + tau * tau * tops.stiffness_diag(coeff).numpy())
    b, x0 = rng.standard_normal(tops.ndofs), rng.standard_normal(tops.ndofs)
    tc, jc = tops.stiff_coeff(coeff), jops.stiff_coeff(coeff)
    mt, mj = torch.from_numpy(m), jnp.asarray(m)

    x, (it, res2) = cg_solve(
        lambda v: mt * v + tau * tau * tops.stiffness_apply([v], [tc]),
        torch.from_numpy(b), torch.from_numpy(x0), torch.from_numpy(dinv), maxiter=maxiter)
    jx, (jit, jres2) = jax_cg_solve(
        lambda v: mj * v + tau * tau * jops.stiffness_apply([v], [jc]),
        jnp.asarray(b), jnp.asarray(x0), jnp.asarray(dinv), maxiter=maxiter)
    assert isinstance(it, int) and it == int(jit)
    assert it == 3 if maxiter == 3 else it > 3
    assert _rel(x, jx) < 1e-12
    assert float(res2) == pytest.approx(float(jres2), rel=1e-6)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("case", sorted(LATTICES) + ["bowl"])
def test_stiffness_diag_matches_jax(case, hetero):
    tmesh, jmesh = _meshes(case)
    coeff = np.random.default_rng(1).uniform(0.5, 2.0, tmesh.num_cells) if hetero else 1.7
    for p in (2, 3):
        tops = SEMOperators(tmesh, p, dtype=torch.float64, device="cpu")
        jops = JaxOps(jmesh, p, dtype=jnp.float64)
        assert (tops.hybrid is not None) == (jops.hybrid is not None) == (case == "bowl")
        kd = tops.stiffness_diag(coeff)
        assert kd.dtype == torch.float64 and kd.shape == (tops.ndofs,)
        assert _rel(kd, jops.stiffness_diag(coeff)) < 1e-13
        if case == "bowl":  # the JAX package's general per-cell assembly
            os.environ["FUS_HYBRID"] = "0"
            try:
                gen = JaxOps(jmesh, p, dtype=jnp.float64)
            finally:
                del os.environ["FUS_HYBRID"]
            assert gen.hybrid is None
            assert _rel(kd, gen.stiffness_diag(coeff)) < 1e-12


def _model_case(kind, case, hetero):
    """(port model, JAX model) of ``kind`` on ``case``'s mesh."""
    tmesh, jmesh = _meshes(case)
    nc = tmesh.num_cells
    rng = np.random.default_rng(7)
    c0 = rng.uniform(0.9, 1.1, nc) if hetero else 1.0
    rho0 = rng.uniform(0.9, 1.1, nc) if hetero else 1.0
    if case == "2d" and kind == "lossy":  # tests/test_sharding.py:152-159
        tmesh, jmesh = (_ends(mod, mod.create_rectangle((7, 4), (0, 0), (1.0, 0.5)), 1.0)
                        for mod in (ft, fus))
        c0 = rng.uniform(0.9, 1.1, tmesh.num_cells) if hetero else 1.0
        rho0 = 1.0
    degree, order, dt = 3, (2 if case == "2d" else 4), 1e-3
    if kind == "linear":
        args = (degree, c0, rho0, 10.0, 1.0, 1.0, order, dt)
        return (ft.LinearSpectralImplicit(tmesh, None, *args, dtype=torch.float64, device="cpu"),
                fus.LinearSpectralImplicit(jmesh, None, *args, dtype=jnp.float64))
    args = (degree, c0, rho0, 1e-3, 10.0, 1.0, 1.0, order, dt)
    return (ft.LossySpectralImplicit(tmesh, None, *args, dtype=torch.float64, device="cpu"),
            fus.LossySpectralImplicit(jmesh, None, *args, dtype=jnp.float64))


def _as_numpy(consts):
    out = {}
    for k, v in consts.items():
        if isinstance(v, list):
            out[k] = [(float(f), [np.asarray(x) for x in vecs]) for f, vecs in v]
        elif isinstance(v, tuple):
            out[k] = tuple(np.asarray(x) for x in v)
        elif isinstance(v, dict):
            out[k] = {n: np.asarray(a) for n, a in v.items()}
        else:
            out[k] = float(v) if np.ndim(v) == 0 else np.asarray(v)
    return out


def _flatten(v):
    """The tensors of a const (a tensor, F dict, hybrid dict or scales)."""
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, dict):
        return [t for k in sorted(v) for t in _flatten(v[k])]
    if isinstance(v, list):
        return [t for fac, vecs in v for t in [torch.tensor(fac)] + list(vecs)]
    return list(v)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("case", ["1d", "2d"])
@pytest.mark.parametrize("kind", ["linear", "lossy"])
def test_implicit_consts_carry_across(kind, case, hetero):
    """The JAX model's consts, lattice scales included, carried across by
    ``convert.consts_from_numpy`` equal the port's own host setup."""
    tm, jm = _model_case(kind, case, hetero)
    converted = consts_from_numpy(_as_numpy(jm.consts), device="cpu")
    assert set(converted) == set(tm.consts)
    for k, v in converted.items():
        if isinstance(v, float):
            assert v == tm.consts[k], k
            continue
        assert type(v) is type(tm.consts[k]), k
        a, b = _flatten(tm.consts[k]), _flatten(v)
        assert len(a) == len(b), k
        for x, y in zip(a, b):
            assert _rel(x, y) < 1e-13, k


STEPS = 12


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("case", sorted(LATTICES) + ["bowl"])
@pytest.mark.parametrize("kind", ["linear", "lossy"])
def test_implicit_model_matches_jax(kind, case, hetero):
    """STEPS SDIRK steps from the same seeded state: u and v within 1e-10
    relative, the same worst CG iteration count."""
    tm, jm = _model_case(kind, case, hetero)
    assert (tm.ops.hybrid is not None) == (case == "bowl")
    rng = np.random.default_rng(5)
    u0, v0 = 1e-3 * rng.standard_normal(jm.ops.ndofs), rng.standard_normal(jm.ops.ndofs)
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    tm.u_n, tm.v_n = state_from_numpy(u0, v0, device="cpu")
    tend = STEPS * tm.dt
    ju, jv, jt = jm.dirk(0.0, tend)
    tu, tv, tt = tm.dirk(0.0, tend)
    assert tt == pytest.approx(float(jt), rel=1e-15)
    assert _rel(tu, ju) < 1e-10 and _rel(tv, jv) < 1e-10
    assert tm.cg_stats["max_iterations"] == jm.cg_stats["max_iterations"] > 0
    assert tm.cg_stats["max_residual2"] == pytest.approx(jm.cg_stats["max_residual2"], rel=1e-4)


def test_plain_ops_match_kernel_ops_on_the_cpu():
    """``SEMOperators.plain()`` runs ``stiffness_plain`` in 3D (on the CPU
    the kernel wrapper runs it too): the same step, the same CG counts."""
    tm, _ = _model_case("lossy", "3d", True)
    rng = np.random.default_rng(2)
    u, v = (torch.from_numpy(rng.standard_normal(tm.ops.ndofs)) for _ in range(2))
    runs = []
    for ops in (None, tm.ops.plain()):
        stats = []
        runs.append((tm.dirk_step(ops=ops, stats=stats)(tm.consts, (u, v, 0.0), tm.dt), stats))
    (a, sa), (b, sb) = runs
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]
    assert [s[0] for s in sa] == [s[0] for s in sb]
    assert tm.ops.plain().stiffness_fn is not tm.ops.stiffness_fn


def test_cg_maxiter_warns():
    tm, _ = _model_case("linear", "1d", False)
    tm.cg_maxiter = 1
    with pytest.warns(UserWarning, match="maxiter"):
        tm.dirk(0.0, 2 * tm.dt)
    assert tm.cg_stats["max_iterations"] == 1


# --------------------------------------------------- tests/test_models_1d.py

F0, C0, L = 10.0, 1.0, 1.0


def _gate_mesh(epw):
    nx = int(epw * (L / (C0 / F0)) + 1)
    return _ends(ft, ft.create_interval(nx, 0.0, L), L), L / nx


@pytest.mark.parametrize("degree, epw", [(3, 8), (4, 4)])
def test_linear_implicit_gate(degree, epw):
    rho0 = 4.0
    p0 = rho0 * C0
    mesh, h = _gate_mesh(epw)
    dt = 0.9 * h / (C0 * degree**2)
    eqn = ft.LinearSpectralImplicit(mesh, None, degree, C0, rho0, F0, p0, C0, 4, dt,
                                    dtype=torch.float64, device="cpu")
    eqn.init()
    u_n, _, tf = eqn.dirk(0.0, L / C0 + 16.0 / F0)
    err = relative_l2_error(eqn.ops, u_n, lambda x: planewave(x[0], tf, C0, F0, p0))
    assert err < 0.05, err


def test_lossy_implicit_gate():
    degree, epw, rho0 = 4, 4, 4.0
    p0 = rho0 * C0
    alphadB = 5.0
    alphaNp = alphadB / 20 * np.log(10)
    delta0 = ft.compute_diffusivity_of_sound(2 * np.pi * F0, C0, alphadB)
    mesh, h = _gate_mesh(epw)
    dt = 0.5 * h / (C0 * degree**2)
    eqn = ft.LossySpectralImplicit(mesh, None, degree, C0, rho0, delta0, F0, p0, C0, 4, dt,
                                   dtype=torch.float64, device="cpu")
    eqn.init()
    u_n, _, tf = eqn.dirk(0.0, L / C0 + 16.0 / F0)
    err = relative_l2_error(eqn.ops, u_n,
                            lambda x: damped_planewave(x[0], tf, C0, F0, p0, alphaNp))
    assert err < 1e-2, err


def test_implicit_dirk_record():
    """``tests/test_models_1d.py::test_implicit_dirk_record`` through the
    port: dirk_record == dirk, the last record equals ``eval_function`` at
    the sensors; and against the JAX ``dirk_record`` (ys, times, cg_stats)."""
    args = (4, C0, 4.0, F0, 4.0, C0, 2, 2e-3)
    mesh, _ = _gate_mesh(2)
    m1 = ft.LinearSpectralImplicit(mesh, None, *args, dtype=torch.float64, device="cpu").init()
    u_ref, v_ref, _ = m1.dirk(0.0, 0.05)
    m2 = ft.LinearSpectralImplicit(mesh, None, *args, dtype=torch.float64, device="cpu").init()
    pts = np.linspace(0.1, 0.9, 5)[None, :]
    u, v, t, times, ys = m2.dirk_record(0.0, 0.05, pts)
    assert isinstance(ys, torch.Tensor) and ys.shape == (len(times), 5)
    scale = float(u_ref.abs().max()) + 1e-300
    assert float((u - u_ref).abs().max()) / scale < 1e-12
    _, interp = ft.eval_function(m2.ops, u, pts)
    np.testing.assert_allclose(ys[-1].numpy(), interp, rtol=0, atol=1e-12 * scale)
    assert m2.cg_stats["max_iterations"] > 0

    jmesh = _ends(fus, fus.create_interval(mesh.num_cells, 0.0, L), L)
    jm = fus.LinearSpectralImplicit(jmesh, None, *args, dtype=jnp.float64).init()
    _, _, jt, jtimes, jys = jm.dirk_record(0.0, 0.05, pts)
    assert times.dtype == np.float64 and np.array_equal(times, jtimes)
    assert t == pytest.approx(jt, rel=1e-15)
    assert _rel(ys, jys) < 1e-10
    assert m2.cg_stats["max_iterations"] == jm.cg_stats["max_iterations"]
