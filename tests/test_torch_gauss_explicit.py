"""The Gauss-quadrature ``LinearExplicit`` of the PyTorch port (consistent
mass, a CG solve at every slope over ``ops/quadrature_ops.py``) against the
JAX package's, fp64 on the CPU:

* on a 3D lattice, a 2D lattice and an unstructured mesh: the preconditioner
  and boundary vectors to 1e-12, the first slope's kv and CG iterations
  equal to the JAX ``cg_solve`` on the JAX model's own system, and u, v
  after 4 RK4 steps within 1e-10 relative;
* the JAX suite's ``test_models_1d.py::test_linear_gauss_explicit`` gate
  (< 1e-3) through the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
from fenicsxfus_tpu.ops.cg import cg_solve as jax_cg_solve
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.analysis.analytical import planewave
from fenicsxfus_tpu_torch.analysis.error import relative_l2_error
from fenicsxfus_tpu_torch.convert import state_from_numpy

torch.set_num_threads(1)


def _rel(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


MODEL_CASES = {
    "3d": ("create_box", ((4, 2, 2), (0, 0, 0), (1.0, 0.4, 0.4)), False),
    "2d": ("create_rectangle", ((6, 3), (0, 0), (1.0, 0.5)), False),
    "unstructured": ("create_rectangle", ((5, 3), (0, 0), (1.0, 0.5)), True),
}


def _linear_explicit(case):
    name, args, unstructured = MODEL_CASES[case]
    models = []
    for mod in (ft, fus):
        mesh = getattr(mod, name)(*args)
        mesh = mod.as_unstructured(mesh) if unstructured else mesh
        mod.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
        margs = (None, 3, 1.0, 1.3, 10.0, 1.0, 1.0, 4, 4e-3)
        models.append(mod.LinearExplicit(mesh, *margs, device="cpu") if mod is ft
                      else mod.LinearExplicit(mesh, *margs, dtype=jnp.float64))
    return models


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_linear_explicit_matches_jax(case):
    tm, jm = _linear_explicit(case)
    assert tm.step_kind == "unfused" and tm.ops.d == jm.ops.d
    assert _rel(tm.mdiag_inv, jm.mdiag_inv) < 1e-12
    assert _rel(tm.src_vec, jm.src_vec) < 1e-13 and _rel(tm.abc_diag, jm.abc_diag) < 1e-13
    rng = np.random.default_rng(6)
    u0, v0 = 1e-3 * rng.standard_normal(tm.ops.ndofs), rng.standard_normal(tm.ops.ndofs)
    # the first slope's solve: the same CG iterations as the JAX cg_solve on
    # the JAX model's system, the same kv
    tu, tv = state_from_numpy(u0, v0, device="cpu")
    tm.cg_log.clear()
    _, kv = tm.rhs(0.01, tu, tv)
    g, _ = jm.source_amplitudes(0.01)
    b = (-jm.qops.stiffness_apply([jnp.asarray(u0)], [jm.stiff_coeff]) + g * jm.src_vec
         - jm.abc_diag * jnp.asarray(v0))
    jkv, (jit, _) = jax_cg_solve(lambda x: jm.qops.mass_apply(x, jm.mass_coeff), b,
                                 b * jm.mdiag_inv, jm.mdiag_inv, rtol=jm.cg_rtol,
                                 maxiter=jm.cg_maxiter)
    assert tm.cg_log == [int(jit)] and int(jit) > 1
    assert _rel(kv, jkv) < 1e-10
    # four RK4 steps
    jm.u_n, jm.v_n = jnp.asarray(u0), jnp.asarray(v0)
    tm.u_n, tm.v_n = tu, tv
    tm.cg_log.clear()
    ju, jv, jt = jm.rk(0.0, 4 * tm.dt)
    u, v, t = tm.rk(0.0, 4 * tm.dt)
    assert len(tm.cg_log) == 16 and max(tm.cg_log) < tm.cg_maxiter
    assert t == pytest.approx(float(jt), rel=1e-15)
    assert _rel(u, ju) < 1e-10 and _rel(v, jv) < 1e-10


def test_linear_gauss_explicit():
    """Gauss-quadrature (consistent-mass) variant, reference test_linear_1d.py
    (``tests/test_models_1d.py::test_linear_gauss_explicit``)."""
    F0, U0, C0, L = 10.0, 1.0, 1.0, 1.0
    degree, epw, rho0 = 4, 4, 4.0
    p0 = rho0 * C0 * U0
    nx = int(epw * (L / (C0 / F0)) + 1)
    mesh = ft.create_interval(nx, 0.0, L)
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > L - 1e-12})
    dt = 0.9 * (L / nx) / (C0 * degree**2)
    eqn = ft.LinearExplicit(mesh, None, degree, C0, rho0, F0, p0, C0, 4, dt, device="cpu")
    eqn.init()
    u_n, _, tf = eqn.rk(0.0, L / C0 + 16.0 / F0)
    err = relative_l2_error(eqn.ops, u_n, lambda x: planewave(x[0], tf, C0, F0, p0))
    assert err < 1e-3, err
