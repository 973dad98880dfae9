"""1D and 2D lattices in the PyTorch port against the JAX package, fp64 on the
CPU:

* the explicit models (linear, lossy, Westervelt) on ``create_interval`` and
  ``create_rectangle`` lattices, constant and heterogeneous media: the
  unfused step (no stage kernel there, as in the JAX package), u and v after
  10 RK4 steps within 1e-10 relative; ``rk_record`` in 2D with sensors on
  and off the nodes;
* ``eval_function`` in d = 1, 2 and 3 within 1e-13;
* the reference's explicit accuracy gates of ``tests/test_models_1d.py`` at
  the JAX package's tier-1 pairs and tolerances, with the same domain, tend
  and dt: linear < 1e-3 and lossy < 1e-2 at (3,8), (4,4), (5,2), (6,2);
  Westervelt < 1e-1 against Fubini at (3,16), (4,8), (5,4), (6,2); the
  Mendousse gate (< 0.1 at the shock distance, through ``eval_function``);
  and the 2D channel of the verify recipe (``create_rectangle((41, 6))``)
  < 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.analysis.analytical import (
    damped_planewave,
    fubini,
    mendousse,
    planewave,
)
from fenicsxfus_tpu_torch.analysis.error import relative_l2_error
from fenicsxfus_tpu_torch.convert import state_from_numpy

torch.set_num_threads(1)


def _rel(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _ends(mod, mesh, L):
    mod.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    return mesh


MESHES = {
    "1d": ("create_interval", (11, 0.0, 1.0)),
    "2d": ("create_rectangle", ((7, 5), (0, 0), (1.0, 0.8))),
}
MODELS = {  # (class name, extra arguments after rho0)
    "linear": ("LinearSpectralExplicit", ()),
    "lossy": ("LossySpectralExplicit", (1e-3,)),
    "westervelt": ("WesterveltSpectralExplicit", (1e-3, 3.5)),
}
DT = 4e-4


def _pair(kind, case, hetero, degree=3):
    """(port model, JAX model) of ``kind`` on ``case``'s mesh, fp64."""
    name, args = MESHES[case]
    tmesh, jmesh = (_ends(mod, getattr(mod, name)(*args), 1.0) for mod in (ft, fus))
    rng = np.random.default_rng(4)
    nc = tmesh.num_cells
    c0 = rng.uniform(0.9, 1.1, nc) if hetero else 1.0
    rho0 = rng.uniform(0.9, 1.1, nc) if hetero else 1.0
    cls, extra = MODELS[kind]
    margs = (degree, c0, rho0) + extra + (10.0, 1.0, 1.0, 4, DT)
    return (getattr(ft, cls)(tmesh, None, *margs, dtype=torch.float64, device="cpu"),
            getattr(fus, cls)(jmesh, None, *margs, dtype=jnp.float64))


def _seed_state(tm, jm, seed=5):
    rng = np.random.default_rng(seed)
    u0, v0 = 1e-2 * rng.standard_normal(jm.ops.ndofs), rng.standard_normal(jm.ops.ndofs)
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    tm.u_n, tm.v_n = state_from_numpy(u0, v0, device="cpu")


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("case", sorted(MESHES))
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_explicit_model_matches_jax(kind, case, hetero):
    tm, jm = _pair(kind, case, hetero)
    assert tm.ops.d == jm.ops.d == int(case[0])
    assert tm.fused_step() is None and tm.step_kind == "unfused"
    assert jm._try_fused_step() is None
    _seed_state(tm, jm)
    ju, jv, jt = jm.rk(0.0, 10 * DT)
    tu, tv, tt = tm.rk(0.0, 10 * DT)
    assert tt == pytest.approx(float(jt), rel=1e-15)
    assert _rel(tu, ju) < 1e-10 and _rel(tv, jv) < 1e-10


@pytest.mark.parametrize("on_node", [True, False])
def test_rk_record_2d_matches_jax(on_node):
    tm, jm = _pair("lossy", "2d", True)
    _seed_state(tm, jm)
    rng = np.random.default_rng(11)
    if on_node:
        coords = tm.ops.dof_coords()
        pts = coords[rng.choice(len(coords), 6, replace=False)].T
    else:
        pts = np.stack([rng.uniform(0.01, 0.99, 6), rng.uniform(0.01, 0.79, 6)])
    _, _, jt, jtimes, jys = jm.rk_record(0.0, 5 * DT, pts)
    _, _, tt, times, ys = tm.rk_record(0.0, 5 * DT, pts)
    assert ys.shape == (5, 6) and np.array_equal(times, jtimes)
    assert tt == pytest.approx(jt, rel=1e-15)
    assert _rel(ys, jys) < 1e-10


@pytest.mark.parametrize("case", ["1d", "2d", "3d"])
def test_eval_function_matches_jax(case):
    grids = {"1d": ("create_interval", (6, 0.0, 1.0)),
             "2d": ("create_rectangle", ((5, 4), (0, 0), (1.0, 0.8))),
             "3d": ("create_box", ((4, 3, 3), (0, 0, 0), (1.0, 0.6, 0.7)))}
    name, args = grids[case]
    tmesh, jmesh = (getattr(mod, name)(*args) for mod in (ft, fus))
    d = tmesh.dim
    tops = ft.SEMOperators(tmesh, 3, dtype=torch.float64, device="cpu")
    jops = fus.SEMOperators(jmesh, 3, dtype=jnp.float64)
    rng = np.random.default_rng(9)
    u = rng.standard_normal(tops.ndofs)
    hi = np.max(tmesh.vertices, axis=0)
    pts = np.stack([rng.uniform(0.0, hi[a], 7) for a in range(d)])
    pts[:, 0] = hi  # a corner node
    tp, tv = ft.eval_function(tops, torch.from_numpy(u), pts)
    jp, jv = fus.eval_function(jops, jnp.asarray(u), pts)
    assert np.array_equal(tp, jp) and tv.shape == (7,)
    assert _rel(tv, jv) < 1e-13
    # a field the basis holds exactly: evaluation is interpolation
    lin = tops.interpolate(lambda x: 1.0 + 2.0 * x[0] - x[d - 1])
    _, vals = ft.eval_function(tops, lin, pts)
    np.testing.assert_allclose(vals, 1.0 + 2.0 * pts[0] - pts[d - 1], atol=1e-13)


# --------------------------------------------------- tests/test_models_1d.py

F0, U0, C0, L = 10.0, 1.0, 1.0, 1.0


def _gate_mesh(epw):
    nx = int(epw * (L / (C0 / F0)) + 1)
    return _ends(ft, ft.create_interval(nx, 0.0, L), L), L / nx


def _run(cls, mesh, degree, args, dt, tend):
    eqn = cls(mesh, None, degree, *args, 4, dt, dtype=torch.float64, device="cpu")
    eqn.init()
    u, _, tf = eqn.rk(0.0, tend)
    assert eqn.step_kind == "unfused"
    return eqn, u, tf


@pytest.mark.parametrize("degree, epw", [(3, 8), (4, 4), (5, 2), (6, 2)])
def test_linear_explicit_gate(degree, epw):
    rho0 = 4.0
    p0 = rho0 * C0 * U0
    mesh, h = _gate_mesh(epw)
    eqn, u, tf = _run(ft.LinearSpectralExplicit, mesh, degree, (C0, rho0, F0, p0, C0),
                      0.9 * h / (C0 * degree**2), L / C0 + 16.0 / F0)
    err = relative_l2_error(eqn.ops, u, lambda x: planewave(x[0], tf, C0, F0, p0))
    assert err < 1e-3, err


@pytest.mark.parametrize("degree, epw", [(3, 8), (4, 4), (5, 2), (6, 2)])
def test_lossy_explicit_gate(degree, epw):
    rho0 = 4.0
    p0 = rho0 * C0 * U0
    alphadB = 5.0
    alphaNp = alphadB / 20 * np.log(10)
    delta0 = ft.compute_diffusivity_of_sound(2 * np.pi * F0, C0, alphadB)
    mesh, h = _gate_mesh(epw)
    eqn, u, tf = _run(ft.LossySpectralExplicit, mesh, degree, (C0, rho0, delta0, F0, p0, C0),
                      0.5 * h / (C0 * degree**2), L / C0 + 16.0 / F0)
    err = relative_l2_error(eqn.ops, u,
                            lambda x: damped_planewave(x[0], tf, C0, F0, p0, alphaNp))
    assert err < 1e-2, err


@pytest.mark.parametrize("degree, epw", [(3, 16), (4, 8), (5, 4), (6, 2)])
def test_westervelt_gate(degree, epw):
    rho0, beta0 = 1.0, 0.01
    p0 = rho0 * C0 * U0
    mesh, h = _gate_mesh(epw)
    eqn, u, tf = _run(ft.WesterveltSpectralExplicit, mesh, degree,
                      (C0, rho0, 0.0, beta0, F0, p0, C0), 0.9 * h / (C0 * degree**2),
                      L / C0 + 8.0 / F0)
    err = relative_l2_error(eqn.ops, u, lambda x: fubini(x[0], tf, C0, F0, p0, rho0, beta0))
    assert err < 1e-1, err


def test_westervelt_vs_mendousse():
    """Nonlinear + thermoviscous propagation against Mendousse's exact
    Burgers solution at the shock-formation distance (the reference's
    MENDOUSSE benchmark), read through ``eval_function``."""
    f0, p0 = 1e6, 5e6
    c0, rho0, beta0 = 1500.0, 1000.0, 4.8
    delta0 = ft.compute_diffusivity_of_sound(2 * np.pi * f0, c0, 25.0)
    xsh = rho0 * c0**3 / beta0 / p0 / (2 * np.pi * f0)
    Ld, degree, epw = 0.03, 4, 6
    nx = int(epw * Ld * f0 / c0 + 1)
    mesh = _ends(ft, ft.create_interval(nx, 0.0, Ld), Ld)
    dt = 0.25 * (Ld / nx) / (c0 * degree**2)
    eqn, u, tf = _run(ft.WesterveltSpectralExplicit, mesh, degree,
                      (c0, rho0, delta0, beta0, f0, p0, c0), dt, Ld / c0 + 8.0 / f0)
    _, vals = ft.eval_function(eqn.ops, u, np.array([[xsh]]))
    exact = float(mendousse(xsh, tf, c0, f0, p0, rho0, beta0, delta0))
    rel = abs(vals[0] - exact) / abs(exact)
    assert rel < 0.1, (vals[0], exact, rel)


def test_channel_2d_gate():
    """The verify recipe's 2D channel: source at x=0, ABC at x=1, lateral
    walls untagged, so exactly a plane wave; degree 4, 4 elements per
    wavelength, CFL 0.9, rel-L2 < 1e-3."""
    f0, p0, c0, rho0 = 10.0, 4.0, 1.0, 4.0
    mesh = _ends(ft, ft.create_rectangle((41, 6), (0, 0), (1.0, 0.15)), 1.0)
    eqn, u, tf = _run(ft.LinearSpectralExplicit, mesh, 4, (c0, rho0, f0, p0, c0),
                      0.9 * (1 / 41) / (c0 * 16), 1.0 / c0 + 16.0 / f0)
    err = relative_l2_error(eqn.ops, u, lambda x: planewave(x[0], tf, c0, f0, p0))
    assert err < 1e-3, err
