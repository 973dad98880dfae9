"""The experimental models of the PyTorch port (``models/experimental.py``)
against the JAX package's, fp64 on the CPU:

* ``LinearSpectralS2``, ``LinearSpectralSponge``, ``LinearSpectralNewmark``,
  ``LinearSpectralAdaptive`` and ``WesterveltSpectralAdaptive`` on a 3D
  lattice (K1's plain twin on the CPU), a 2D lattice (``apply_scaled``) and
  an unstructured 2D mesh (the general path, the sponge's nodal δ through
  ``qcoeff``), from one seeded state: u, v (Newmark's w) within 1e-10
  relative; Newmark's CG iteration count of every step equal to the JAX
  ``cg_solve`` on the JAX model's own system; the adaptive attempt count
  and final time equal; the consts carried across by ``convert.py`` equal
  the port's own to 1e-13;
* the controller's step factor (``err == 0`` gives 10, as in JAX).

The JAX suite's gates for these models run through the port in
``tests/test_torch_experimental_gates.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
from fenicsxfus_tpu.models import experimental as jexp
from fenicsxfus_tpu.models.base import source_amplitudes as jax_source_amplitudes
from fenicsxfus_tpu.ops.cg import cg_solve as jax_cg_solve
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.convert import consts_from_numpy, field_from_numpy, state_from_numpy
from fenicsxfus_tpu_torch.models.experimental import heaviside_window, step_factor

torch.set_num_threads(1)


def _rel(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# (mesh function, arguments, as_unstructured): the domain is [0, 1] along x
CASES = {
    "3d": ("create_box", ((4, 3, 3), (0, -0.3, -0.35), (1.0, 0.3, 0.35)), False),
    "2d": ("create_rectangle", ((6, 5), (0, -0.4), (1.0, 0.4)), False),
    "unstructured": ("create_rectangle", ((5, 4), (0, -0.4), (1.0, 0.4)), True),
}


def _meshes(case):
    """The same tagged mesh built by each package: (port, JAX)."""
    name, args, unstructured = CASES[case]
    out = []
    for mod in (ft, fus):
        mesh = getattr(mod, name)(*args)
        if unstructured:
            mesh = mod.as_unstructured(mesh)
        mod.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
        out.append(mesh)
    return out


def _state(n, seed=5, scale=1e-3):
    rng = np.random.default_rng(seed)
    return scale * rng.standard_normal(n), rng.standard_normal(n)


def _set_state(tm, jm, u0, v0):
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    tm.u_n, tm.v_n = state_from_numpy(u0, v0, device="cpu")


def _lattice_kind(tm, jm, case):
    assert (tm.ops.lattice is None) == (jm.ops.lattice is None) == (case == "unstructured")


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
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, dict):
        return [t for k in sorted(v) for t in _flatten(v[k])]
    if isinstance(v, list):
        return [t for fac, vecs in v for t in [torch.tensor(fac)] + list(vecs)]
    return list(v)


def _assert_consts_carry(tm, jm):
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


# ------------------------------------------------------------ S2 and sponge


def _s2(case):
    tmesh, jmesh = _meshes(case)
    args = (3, 1.0, 1.3, 10.0, 1.0, 1.0)
    prof = heaviside_window(-0.2, 0.15, axis=1)
    tm = ft.LinearSpectralS2(tmesh, None, *args, source_profile=prof, dtype=torch.float64,
                             device="cpu")
    jm = fus.LinearSpectralS2(jmesh, None, *args, source_profile=jexp.heaviside_window(
        -0.2, 0.15, axis=1), dtype=jnp.float64)
    return tm, jm


def _sponge(case):
    tmesh, jmesh = _meshes(case)
    # c0 = 1, f0 = 10: lambda = 0.1, delta0 5e-3 gives a slope 1e-2 / unit length
    args = (3, 1.0, 1.3, 5e-3, 10.0, 1.0, 1.0)
    tm = ft.LinearSpectralSponge(tmesh, None, *args, sponge_start=0.55, dtype=torch.float64,
                                 device="cpu")
    jm = fus.LinearSpectralSponge(jmesh, None, *args, sponge_start=0.55, dtype=jnp.float64)
    return tm, jm


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["s2", "sponge"])
def test_explicit_experimental_matches_jax(kind, case):
    """10 RK4 steps (``rk4``) from the same seeded state: u and v within
    1e-10; the port takes the unfused step (no fused kind), and off the 3D
    lattice the consts carry across."""
    tm, jm = (_s2 if kind == "s2" else _sponge)(case)
    _lattice_kind(tm, jm, case)
    if case != "3d":  # in 3D the JAX package packs lattice scales off the TPU, the port F
        _assert_consts_carry(tm, jm)
    if kind == "sponge":
        assert float(np.max(tm.delta_nodal)) > 0 and np.array_equal(tm.delta_nodal,
                                                                    jm.delta_nodal)
    u0, v0 = _state(tm.ops.ndofs)
    _set_state(tm, jm, u0, v0)
    dt = 2e-3
    ju, jv, jt = jm.rk4(0.0, 10 * dt, dt)
    tu, tv, tt = tm.rk4(0.0, 10 * dt, dt)
    assert tm.step_kind == "unfused"
    assert tt == pytest.approx(float(jt), rel=1e-15)
    assert _rel(tu, ju) < 1e-10 and _rel(tv, jv) < 1e-10


def test_s2_source_vector_is_the_windowed_profile():
    """The S2 source vector is zero off the window and equal to the JAX
    package's on it."""
    tm, jm = _s2("2d")
    src = tm.consts["src_vec"].numpy()
    coords = tm.ops.space.dof_coords
    assert np.all(src[(coords[:, 1] < -0.2) | (coords[:, 1] > 0.15)] == 0)
    assert np.count_nonzero(src) > 0 and _rel(src, jm.consts["src_vec"]) < 1e-13


# ------------------------------------------------------------------ Newmark


def _newmark(case):
    tmesh, jmesh = _meshes(case)
    args = (3, 1.0, 1.3, 10.0, 1.0, 1.0, 4e-3)
    return (ft.LinearSpectralNewmark(tmesh, None, *args, device="cpu"),
            fus.LinearSpectralNewmark(jmesh, None, *args, dtype=jnp.float64))


def _jax_newmark_iterations(jm, u, v, w, dts):
    """The JAX Newmark step replayed with the JAX ``cg_solve`` on the JAX
    model's own operator (``_A``): each step's CG iterations."""
    consts = jm.base_consts()
    g_, b_ = jm.gamma, jm.beta
    its, t = [], 0.0
    for dtn in dts:
        t1 = t + dtn
        g, _ = jax_source_amplitudes(consts, t1)
        upred = u + dtn * v + 0.5 * dtn * dtn * (1 - 2 * b_) * w
        b = (-jm.abc_diag * (v + (1 - g_) * dtn * w)
             - jm.ops.stiffness_apply([upred], [jm.coeff_u]) + g * jm.src_vec)
        dinv = 1.0 / (jm.m + (g_ * dtn) * jm.abc_diag + (b_ * dtn * dtn) * jm.kdiag)
        w1, (it, _) = jax_cg_solve(lambda x: jm._A(dtn, x), b, w, dinv, rtol=jm.cg_rtol,
                                   maxiter=jm.cg_maxiter)
        its.append(int(it))
        u, v = (u + dtn * v + 0.5 * dtn * dtn * ((1 - 2 * b_) * w + 2 * b_ * w1),
                v + (1 - g_) * dtn * w + g_ * dtn * w1)
        w, t = w1, t1
    return its


@pytest.mark.parametrize("case", sorted(CASES))
def test_newmark_matches_jax(case):
    """6 Newmark steps from the same seeded (u, v, w): u, v, w within
    1e-10; the same CG iterations every step; the operands (m, kdiag,
    src_vec, abc_diag) equal to the JAX model's to 1e-13."""
    tm, jm = _newmark(case)
    _lattice_kind(tm, jm, case)
    for k in ("m", "kdiag", "src_vec", "abc_diag"):
        assert _rel(tm.consts[k], getattr(jm, k)) < 1e-13, k
    u0, v0 = _state(tm.ops.ndofs)
    w0 = np.random.default_rng(9).standard_normal(tm.ops.ndofs)
    _set_state(tm, jm, u0, v0)
    jm.w_n = jnp.asarray(w0)
    tm.w_n = field_from_numpy(w0, device="cpu")
    tend = 6 * tm.dt
    ju, jv, jw, jt = jm.newmark(0.0, tend)
    tu, tv, tw, tt = tm.newmark(0.0, tend)
    assert tt == pytest.approx(float(jt), rel=1e-15)
    assert _rel(tu, ju) < 1e-10 and _rel(tv, jv) < 1e-10 and _rel(tw, jw) < 1e-10
    its = _jax_newmark_iterations(jm, jnp.asarray(u0), jnp.asarray(v0), jnp.asarray(w0),
                                  [tm.dt] * 6)
    assert tm.cg_stats["iterations"] == its and min(its) > 0


def test_newmark_plain_ops_equal_on_the_cpu():
    """``newmark_step(ops=ops.plain())`` equals the model's step on a 3D
    lattice (on the CPU both run the plain stiffness), CG counts too."""
    tm, _ = _newmark("3d")
    u, v = state_from_numpy(*_state(tm.ops.ndofs), device="cpu")
    w = torch.zeros_like(u)
    runs = []
    for ops in (None, tm.ops.plain()):
        stats = []
        runs.append((tm.newmark_step(ops=ops, stats=stats)(tm.consts, (u, v, w, 0.0), tm.dt),
                     [s[0] for s in stats]))
    (a, sa), (b, sb) = runs
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])) and sa == sb


def test_newmark_maxiter_warns():
    tm, _ = _newmark("2d")
    tm.cg_maxiter = 1
    with pytest.warns(UserWarning, match="maxiter"):
        tm.newmark(0.0, 2 * tm.dt)
    assert tm.cg_stats["max_iterations"] == 1


# ----------------------------------------------------------------- adaptive


def _adaptive(kind, case):
    tmesh, jmesh = _meshes(case)
    if kind == "linear":
        args = (3, 1.0, 1.3, 10.0, 1.0, 1.0)
        return (ft.LinearSpectralAdaptive(tmesh, None, *args, device="cpu", atol=1e-7,
                                          rtol=1e-7),
                fus.LinearSpectralAdaptive(jmesh, None, *args, dtype=jnp.float64, atol=1e-7,
                                           rtol=1e-7))
    args = (3, 1.0, 1.3, 2e-3, 0.01, 10.0, 1.0, 1.0)
    return (ft.WesterveltSpectralAdaptive(tmesh, None, *args, device="cpu", atol=1e-7,
                                          rtol=1e-7),
            fus.WesterveltSpectralAdaptive(jmesh, None, *args, dtype=jnp.float64, atol=1e-7,
                                           rtol=1e-7))


TEND = 0.2  # about ten steps at the stability limit: the controller rejects some


def _smooth_state(ops):
    """A smooth (u, v) at the DOF coordinates (a random one would hold the
    step at its high modes' accuracy limit)."""
    x = ops.space.dof_coords
    return 1e-3 * np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]), np.cos(4 * x[:, 0] + x[:, 1])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["linear", "westervelt"])
def test_adaptive_matches_jax(kind, case):
    """The adaptive march over [0, TEND] from the same seeded state: the
    same attempt count (rejects included) and final time, u and v within
    1e-10."""
    tm, jm = _adaptive(kind, case)
    _lattice_kind(tm, jm, case)
    _set_state(tm, jm, *_smooth_state(tm.ops))
    ju, jv, jt, jsteps = jm.rk(0.0, TEND)
    tu, tv, tt, tsteps = tm.rk(0.0, TEND)
    assert tsteps == int(jsteps) == tm.nsteps
    assert tm.naccepted < tm.nsteps  # some attempts were rejected
    assert tt == pytest.approx(float(jt), rel=1e-14) and tt == pytest.approx(TEND, rel=1e-14)
    assert _rel(tu, ju) < 1e-10 and _rel(tv, jv) < 1e-10


def test_adaptive_log_and_max_steps():
    """``adaptive(max_steps=5, log=...)`` stops after five attempts, logs
    each one, and leaves the model's state as it was."""
    tm, _ = _adaptive("linear", "3d")
    u0, v0 = state_from_numpy(*_smooth_state(tm.ops), device="cpu")
    tm.u_n, tm.v_n = u0, v0
    log = []
    u, v, t, steps = tm.adaptive(0.0, 0.02, max_steps=5, log=log)
    assert steps == 5 and len(log) == 5 and 0 < t < 0.02
    assert tm.u_n is u0 and tm.v_n is v0
    plain_log = []
    up, _, tp, _ = tm.adaptive(0.0, 0.02, ops=tm.ops.plain(), max_steps=5, log=plain_log)
    assert [a for a, _ in log] == [a for a, _ in plain_log] and tp == t
    assert torch.equal(u, up)


def test_step_factor_matches_jax():
    for err in (0.0, 1e-30, 1e-6, 0.5, 1.0, 3.0, 1e6):
        with np.errstate(divide="ignore"):
            ref = float(jnp.clip(0.9 * jnp.asarray(err, jnp.float64) ** (-0.2), 0.2, 10.0))
        assert step_factor(err) == ref
    assert step_factor(0.0) == 10.0 and step_factor(1e12) == 0.2


def test_aliases():
    assert ft.LinearSpectralSciPy is ft.LinearSpectralAdaptive
    assert ft.WesterveltSpectralSciPy is ft.WesterveltSpectralAdaptive
