"""The nodal-coefficient stiffness and the Gauss-quadrature operators of the
PyTorch port against the JAX package, fp64 on the CPU:

* ``LatticeStiffness.scales_nodal``/``_unfold``/``mass_diag_nodal`` on 1D,
  2D and 3D lattices to 1e-12 (each axis a full tensor, never the rank-1
  form);
* ``SEMOperators.stiffness_apply_nodal`` on those lattices (packed scales
  and a raw nodal array) and on unstructured 2D and 3D meshes through the
  ``qcoeff`` of both cell routes, to 1e-12, and equal to the DG-0 apply
  for a constant nodal coefficient;
* ``QuadratureOperators`` (``gauss_rule_01``, ``_lagrange_derivative``,
  ``mass_apply``, ``mass_diag``, ``stiffness_apply``) on the lattices and
  the unstructured meshes, to 1e-12; on a lattice the gather and the fold
  number the DOFs as the JAX package's ``space.dofmap``.

``LinearExplicit``, the model over these operators, is held to the JAX
package's in ``tests/test_torch_gauss_explicit.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
from fenicsxfus_tpu.ops.lattice import LatticeStiffness as JaxLattice
from fenicsxfus_tpu.ops.operators import SEMOperators as JaxOps
from fenicsxfus_tpu.ops.quadrature_ops import QuadratureOperators as JaxQuad
from fenicsxfus_tpu.ops.quadrature_ops import _lagrange_derivative as jax_lagrange_derivative
from fenicsxfus_tpu.ops.quadrature_ops import gauss_rule_01 as jax_gauss_rule_01
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.core.gll import gll_points_weights_01
from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
from fenicsxfus_tpu_torch.ops.operators import SEMOperators
from fenicsxfus_tpu_torch.ops.quadrature_ops import (
    QuadratureOperators,
    _lagrange_derivative,
    gauss_rule_01,
)

torch.set_num_threads(1)


def _rel(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


MESHES = {
    "1d": ("create_interval", (7, 0.0, 1.0), False),
    "2d": ("create_rectangle", ((4, 3), (0, 0), (1.0, 0.7)), False),
    "3d": ("create_box", ((3, 2, 4), (0, 0, 0), (1.0, 0.6, 0.8)), False),
    "unstructured-2d": ("create_rectangle", ((4, 3), (0, 0), (1.0, 0.7)), True),
    "unstructured-3d": ("create_box", ((3, 2, 2), (0, 0, 0), (1.0, 0.6, 0.8)), True),
}


def _meshes(case):
    name, args, unstructured = MESHES[case]
    out = []
    for mod in (ft, fus):
        mesh = getattr(mod, name)(*args)
        out.append(mod.as_unstructured(mesh) if unstructured else mesh)
    return out


def _ops(case, p):
    tmesh, jmesh = _meshes(case)
    tops = SEMOperators(tmesh, p, dtype=torch.float64, device="cpu")
    jops = JaxOps(jmesh, p, dtype=jnp.float64)
    assert (tops.lattice is None) == (jops.lattice is None) == case.startswith("unstructured")
    return tops, jops


LATTICES = [((7,), (0.14,)), ((4, 3), (0.25, 0.2)), ((3, 2, 4), (0.3, 0.25, 0.2))]


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("grid, h", LATTICES)
def test_scales_nodal_match_jax(grid, h, p):
    tl, jl = LatticeStiffness(grid, p, h), JaxLattice(grid, p, h, jnp.float64)
    c = np.random.default_rng(p).uniform(0.5, 2.0, tl.gdims)
    ts, js = tl.scales_nodal(c), jl.scales_nodal(c)
    assert isinstance(ts, tuple) and len(ts) == len(grid)
    for a, (x, y) in enumerate(zip(ts, js)):
        shape = list(tl.gdims)
        shape[a] = grid[a] * (p + 1)
        assert isinstance(x, np.ndarray) and x.shape == tuple(shape)
        assert _rel(x, y) < 1e-12
        assert np.array_equal(tl._unfold(c, a), jl._unfold(c, a))
    assert _rel(tl.mass_diag_nodal(c), jl.mass_diag_nodal(c)) < 1e-12


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", sorted(MESHES))
def test_stiffness_apply_nodal_matches_jax(case, p):
    tops, jops = _ops(case, p)
    rng = np.random.default_rng(11 + p)
    c = rng.uniform(0.5, 2.0, tops.ndofs)
    xs = [rng.standard_normal(tops.ndofs) for _ in range(2)]
    c2 = rng.uniform(0.5, 2.0, tops.ndofs)
    routes = ["1", "0"] if tops.lattice is None else ["1"]
    for route in routes:  # the dense cell route and the sum-factorised chain
        os.environ["FUS_DENSE_TAB"] = route
        try:
            if tops.lattice is not None:
                tc, tc2 = tops.pack_scales_nodal(c), c2  # packed, and raw: packed per call
                jc, jc2 = jops.pack_scales_nodal(c), c2
                assert isinstance(tc, tuple) and all(isinstance(t, torch.Tensor) for t in tc)
            else:
                tc, tc2 = torch.from_numpy(c), torch.from_numpy(c2)
                jc, jc2 = jnp.asarray(c), jnp.asarray(c2)
            y = tops.stiffness_apply_nodal([torch.from_numpy(x) for x in xs], [tc, tc2])
            yj = jops.stiffness_apply_nodal([jnp.asarray(x) for x in xs], [jc, jc2])
        finally:
            del os.environ["FUS_DENSE_TAB"]
        assert y.shape == (tops.ndofs,) and _rel(y, yj) < 1e-12
    # a constant nodal coefficient is the DG-0 apply of that constant
    ones = np.full(tops.ndofs, 1.7)
    cn = tops.pack_scales_nodal(ones) if tops.lattice is not None else torch.from_numpy(ones)
    x = torch.from_numpy(xs[0])
    assert _rel(tops.stiffness_apply_nodal([x], [cn]),
                tops.stiffness_apply([x], [tops.stiff_coeff(1.7)])) < 1e-12


@pytest.mark.parametrize("nq", [2, 5, 7])
def test_gauss_rule_and_derivative_match_jax(nq):
    x, w = gauss_rule_01(nq)
    jx, jw = jax_gauss_rule_01(nq)
    assert np.array_equal(x, jx) and np.array_equal(w, jw)
    assert w.sum() == pytest.approx(1.0, rel=1e-14)
    for N in (2, 5):
        nodes, _ = gll_points_weights_01(N)
        pts = np.concatenate([x, nodes[:2]])  # off the nodes and on them
        assert np.array_equal(_lagrange_derivative(nodes, pts),
                              jax_lagrange_derivative(nodes, pts))


@pytest.mark.parametrize("p, nq", [(2, None), (4, None), (3, 7)])
@pytest.mark.parametrize("case", sorted(MESHES))
def test_quadrature_operators_match_jax(case, p, nq):
    tops, jops = _ops(case, p)
    if tops.lattice is not None:  # the gather and fold number the lattice as the JAX dofmap
        assert np.array_equal(tops.gidx.numpy(), np.asarray(jops.gidx).reshape(-1))
    tq, jq = QuadratureOperators(tops, nq), JaxQuad(jops, nq)
    assert tq.nq == jq.nq == (nq or p + 2)
    rng = np.random.default_rng(3 * p)
    cc = rng.uniform(0.5, 2.0, tops.num_cells)
    x = rng.standard_normal(tops.ndofs)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    assert _rel(tq.mass_apply(xt, cc), jq.mass_apply(xj, cc)) < 1e-12
    assert _rel(tq.mass_apply(xt, 1.3), jq.mass_apply(xj, 1.3)) < 1e-12
    assert _rel(tq.mass_diag(cc), jq.mass_diag(cc)) < 1e-12
    x2 = rng.standard_normal(tops.ndofs)
    y = tq.stiffness_apply([xt, torch.from_numpy(x2)], [cc, 0.7])
    yj = jq.stiffness_apply([xj, jnp.asarray(x2)], [cc, 0.7])
    assert _rel(y, yj) < 1e-12
    # constants: no stiffness, and the consistent mass sums to the volume
    ones = torch.ones(tops.ndofs, dtype=torch.float64)
    assert float(tq.stiffness_apply([ones], [cc]).abs().max()) < 1e-12
    vol = float(np.prod(np.ptp(tops.mesh.vertices, axis=0)))
    assert float(tq.mass_apply(ones, 1.0).sum()) == pytest.approx(vol, rel=1e-13)
