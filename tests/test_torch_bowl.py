"""The bowl-fitted mesh of the PyTorch port against the JAX package's, fp64 on
the CPU: ``create_bowl_box`` (three sizes, the long-blend rescue of
``tests/test_bowl.py`` among them), the point location and sensors on the
deformed slab (``tests/test_hybrid.py::test_sensor_indices_on_bowl_mesh``),
``estimate_stable_dt``, and a small HITU run on the bowl mesh through
``drivers.hitu.run(..., bowl=True)`` against the JAX package's
(``benchmarks/hitu/common.py``).
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
from fenicsxfus_tpu.core.bowl import bowl_cap_area as jax_bowl_cap_area
from fenicsxfus_tpu.core.bowl import create_bowl_box as jax_create_bowl_box
from fenicsxfus_tpu.core.geometry import facet_factors as jax_facet_factors
from fenicsxfus_tpu.core.geometry import volume_factors as jax_volume_factors
from fenicsxfus_tpu.core.space import build_space as jax_build_space
from fenicsxfus_tpu.utils import compute_eval_params as jax_compute_eval_params
from fenicsxfus_tpu.utils import estimate_stable_dt as jax_estimate_stable_dt
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.core.bowl import bowl_cap_area, create_bowl_box
from fenicsxfus_tpu_torch.core.geometry import facet_factors, volume_factors
from fenicsxfus_tpu_torch.core.space import build_space
from fenicsxfus_tpu_torch.drivers import hitu
from fenicsxfus_tpu_torch.utils import compute_eval_params, estimate_stable_dt

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "hitu_common",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "benchmarks", "hitu", "common.py"),
)
jax_hitu = importlib.util.module_from_spec(_spec)
sys.modules.setdefault("hitu_common", jax_hitu)
_spec.loader.exec_module(jax_hitu)

BOX = ((0, 0, 0), (1.0, 0.9, 0.9), 0.7, 0.35)  # lo, hi, R, a of tests/test_bowl.py

# (n, keyword arguments): the hybrid tests' meshes, and the long blend (9
# sagittae) whose band needs the validity rescue (tests/test_bowl.py:85)
MESHES = [((8, 7, 7), {}), ((10, 8, 8), {}), ((14, 12, 12), {"blend": 0.84})]


@pytest.mark.parametrize("n,kw", MESHES)
def test_create_bowl_box_matches_jax(n, kw):
    got, focus = create_bowl_box(n, *BOX, **kw)
    ref, ref_focus = jax_create_bowl_box(n, *BOX, **kw)
    assert np.array_equal(got.vertices, ref.vertices)
    assert np.array_equal(got.cells, ref.cells)
    assert np.array_equal(focus, ref_focus)
    assert got.grid_shape == ref.grid_shape and got.uniform_hint is False
    assert got.blend_layers == ref.blend_layers
    for a, b in zip(got.uniform_box, ref.uniform_box):
        assert np.array_equal(a, b)
    assert sorted(got.facet_tags) == sorted(ref.facet_tags)
    for tag in ref.facet_tags:
        assert np.array_equal(got.facet_tags[tag], ref.facet_tags[tag])


@pytest.mark.parametrize("N", [3, 5])
def test_geometry_on_bowl_mesh_matches_jax(N):
    """The per-cell Jacobian factors of the deformed cells and the facet
    factors of the curved cap (tag 1) and of the ABC faces (tag 2) equal the
    JAX package's, and the cap's facet weights sum to its area."""
    mesh, _ = create_bowl_box((10, 8, 8), *BOX)
    jmesh, _ = jax_create_bowl_box((10, 8, 8), *BOX)
    for a, b in zip(volume_factors(mesh, N), jax_volume_factors(jmesh, N)):
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=0)
    space, jspace = build_space(mesh, N - 1), jax_build_space(jmesh, N - 1)
    for tag in (1, 2):
        got = facet_factors(mesh, space, mesh.facet_tags[tag])
        ref = jax_facet_factors(jmesh, jspace, jmesh.facet_tags[tag])
        assert np.array_equal(got[0], np.asarray(ref[0])) and np.array_equal(got[2], ref[2])
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-13, atol=0)
    cap = facet_factors(mesh, space, mesh.facet_tags[1])[1].sum()
    assert abs(cap - bowl_cap_area(0.7, 0.35)) < 0.05 * bowl_cap_area(0.7, 0.35)


def test_fus_hybrid_0_raises(monkeypatch):
    """``FUS_HYBRID=0`` on the bowl mesh takes the general per-cell path
    (no lattice, the lattice numbering): its operators against the JAX
    package's ``FUS_HYBRID=0`` operators and against the port's hybrid
    path, to 1e-10 (as ``tests/test_hybrid.py:83``), constant and DG-0
    coefficients, one and two fields."""
    mesh, _ = create_bowl_box((6, 5, 5), *BOX)
    jmesh_, _ = jax_create_bowl_box((6, 5, 5), *BOX)
    hyb = ft.SEMOperators(mesh, 2, dtype=torch.float64, device="cpu")
    monkeypatch.setenv("FUS_HYBRID", "0")
    gen = ft.SEMOperators(mesh, 2, dtype=torch.float64, device="cpu")
    jgen = fus.SEMOperators(jmesh_, 2, dtype=jnp.float64)
    assert hyb.hybrid is not None
    assert gen.hybrid is None and gen.lattice is None and jgen.lattice is None
    assert np.array_equal(gen.space.dofmap, np.asarray(jgen.space.dofmap))
    rng = np.random.default_rng(7)
    x, x2 = rng.standard_normal((2, gen.ndofs))
    cfield = rng.uniform(0.5, 2.0, gen.num_cells)

    def rel(a, b):
        return np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b)))

    for xs, coeffs in (([x], [1.0]), ([x], [cfield]), ([x, x2], [cfield, 0.7])):
        ref = np.asarray(jgen.stiffness_apply([jnp.asarray(v) for v in xs], coeffs))
        tx = [torch.from_numpy(v) for v in xs]
        y = gen.stiffness_apply(tx, [gen.stiff_coeff(c) for c in coeffs]).numpy()
        assert rel(y, ref) < 1e-10
        assert rel(hyb.stiffness_apply(tx, coeffs).numpy(), y) < 1e-10
    for coeff in (1.0, cfield):
        assert rel(gen.assemble_diag(coeff), jgen.assemble_diag(coeff)) < 1e-10
        assert rel(hyb.assemble_diag(coeff), gen.assemble_diag(coeff)) < 1e-10
        assert rel(gen.stiffness_diag(coeff), jgen.stiffness_diag(coeff)) < 1e-10
        assert rel(hyb.stiffness_diag(coeff), gen.stiffness_diag(coeff)) < 1e-10


def test_bowl_cap_area_matches_jax():
    for R, a in ((0.7, 0.35), (0.0632, 0.032), (0.035, 0.0165)):
        assert bowl_cap_area(R, a) == jax_bowl_cap_area(R, a)


def _models(n=(12, 10, 10)):
    """The linear model of ``tests/test_hybrid.py::
    test_sensor_indices_on_bowl_mesh`` in the port and in the JAX package."""
    args = (None, 4, 1.0, 1.0, 3.0, 1.0, 1.0, 4, 1e-4)
    port = ft.LinearSpectralExplicit(create_bowl_box(n, *BOX)[0], *args, dtype=torch.float64,
                                     device="cpu")
    ref = fus.LinearSpectralExplicit(jax_create_bowl_box(n, *BOX)[0], *args, dtype=jnp.float64)
    assert port.ops.hybrid is not None and ref.ops.hybrid is not None
    return port, ref


def test_sensors_on_bowl_mesh_match_jax():
    """Sensor indices and interpolation tables on the bowl mesh equal the
    JAX package's: the snap from the uniform box's origin beyond the slab,
    and inside it the nearest true node (indices) and the Newton inverse map
    (tables)."""
    port, ref = _models()
    xs = np.concatenate([np.array([0.0, 0.05, 0.12, 0.2]), np.linspace(0.45, 0.9, 6)])
    pts = np.stack([xs, np.full_like(xs, 0.45), np.full_like(xs, 0.41)])
    assert np.array_equal(port.sensor_indices(pts), ref.sensor_indices(pts))
    rows, wts = port.sensor_interp_tables(pts)
    rows_ref, wts_ref = ref.sensor_interp_tables(pts)
    assert np.array_equal(rows, rows_ref)
    np.testing.assert_allclose(wts, wts_ref, rtol=0, atol=1e-13)
    # inside the slab: exactly the nearest true node
    coords = port.ops.dof_coords()
    got = coords[port.sensor_indices(pts)]
    for j in range(4):
        d_best = np.min(np.linalg.norm(coords - pts[:, j][None, :], axis=1))
        assert np.linalg.norm(got[j] - pts[:, j]) < d_best + 1e-12


def test_compute_eval_params_matches_jax():
    mesh, _ = create_bowl_box((8, 7, 7), *BOX)
    jmesh, _ = jax_create_bowl_box((8, 7, 7), *BOX)
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-0.05, 0.4, 12), rng.uniform(0.1, 0.8, 12),
                    rng.uniform(0.1, 0.8, 12)])
    for a, b in zip(compute_eval_params(mesh, pts), jax_compute_eval_params(jmesh, pts)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)


def test_estimate_stable_dt_matches_jax():
    """The same power iteration, start vector and Rayleigh step on the
    hybrid operators, constant and heterogeneous media."""
    n = (8, 7, 7)
    mesh, _ = create_bowl_box(n, *BOX)
    jmesh, _ = jax_create_bowl_box(n, *BOX)
    tops = ft.SEMOperators(mesh, 3, dtype=torch.float64, device="cpu")
    jops = fus.SEMOperators(jmesh, 3, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    for c0, rho0 in ((1480.0, 1000.0),
                     (rng.uniform(1400, 1600, mesh.num_cells), rng.uniform(900, 1100, mesh.num_cells))):
        got = estimate_stable_dt(tops, c0, rho0, rk_order=4)
        ref = jax_estimate_stable_dt(jops, c0, rho0, rk_order=4)
        assert abs(got - ref) < 1e-10 * ref


def test_small_bowl_run_matches_jax():
    """``run(..., bowl=True)`` at nx = 10, p = 2, fp64: the port (the fused
    ``westervelt`` K2 step with its band, plain on the CPU) against the JAX
    package's ``build_bowl_model`` + ``rk_record`` (its default path on the
    CPU: the unfused hybrid scan)."""
    kw = dict(nx=10, degree=2, f0=1e5, final_time=2e-5)
    x_ref, amp_ref = jax_hitu.run("W", "H101", "WATER", dtype=jnp.float64, bowl=True, **kw)
    res = hitu.run("W", "H101", "WATER", dtype=torch.float64, device="cpu", bowl=True, **kw)
    model = res.model
    assert model.step_kind == "fused" and model.ops.hybrid is not None
    assert set(res.setup_split) == {"library", "mesh", "context", "operators", "assembly",
                                    "source", "upload", "stable_dt", "other"}
    np.testing.assert_array_equal(res.x, x_ref)
    assert np.max(np.abs(res.amplitude - amp_ref)) < 1e-10 * np.max(np.abs(amp_ref))


def test_bowl_run_refuses_nyz():
    with pytest.raises(ValueError):
        hitu.run("W", "H101", "WATER", nx=6, degree=2, f0=1e5, final_time=1e-6, bowl=True,
                 nyz=4, device="cpu")


def test_build_bowl_model_matches_jax():
    """``build_bowl_model``: the same mesh, the same clamped dt and steps
    per period, and the same consts as the JAX package's."""
    model, h, dt, spp = hitu.build_bowl_model("W", "H101", "WATER", 10, degree=2, f0=1e5,
                                              dtype=torch.float64, device="cpu")
    ref, h_ref, dt_ref, spp_ref = jax_hitu.build_bowl_model("W", "H101", "WATER", 10, degree=2,
                                                            f0=1e5, dtype=jnp.float64)
    assert (h, spp) == (h_ref, spp_ref) and abs(dt - dt_ref) < 1e-12 * dt_ref
    assert model.dt == dt and np.array_equal(model.mesh.vertices, ref.mesh.vertices)
    for k in ("m0", "d2", "src_vec", "src_vec_d", "abc_diag"):
        a, b = model.consts[k].numpy(), np.asarray(ref.consts[k])
        assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(b)), k
