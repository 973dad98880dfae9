"""Host layer of the PyTorch port (fenicsxfus_tpu_torch.core) against the JAX
package: the copied numpy modules must give bit-identical meshes, tags,
dofmaps, geometry factors and GLL tables, and the port must not import jax.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsxfus_tpu.core import geometry as jgeom
from fenicsxfus_tpu.core import gll as jgll
from fenicsxfus_tpu.core import mesh as jmesh
from fenicsxfus_tpu.core import space as jspace
from fenicsxfus_tpu.ops.operators import SEMOperators as JaxOps
from fenicsxfus_tpu_torch.core import geometry as tgeom
from fenicsxfus_tpu_torch.core import gll as tgll
from fenicsxfus_tpu_torch.core import mesh as tmesh
from fenicsxfus_tpu_torch.core import space as tspace
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch import parallel
from fenicsxfus_tpu_torch.convert import state_from_numpy
from fenicsxfus_tpu_torch.drivers import hitu
from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
from fenicsxfus_tpu_torch.ops.operators import SEMOperators
from fenicsxfus_tpu_torch.ops.stiffness import pack_const

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BOXES = [((9, 5, 7), (0.9, 0.7, 0.5), 2), ((9, 5, 7), (0.9, 0.7, 0.5), 4),
         ((6, 4, 4), (1.0, 0.5, 0.5), 3)]


def _tagged(mod, grid, hi):
    mesh = mod.create_box(grid, (0, 0, 0), hi)
    mod.tag_boundaries(
        mesh,
        {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > hi[0] - 1e-12},
        default=3,
    )
    return mesh


@pytest.mark.parametrize("grid,hi,degree", BOXES)
def test_mesh_space_geometry_match_jax(grid, hi, degree):
    jm, tm = _tagged(jmesh, grid, hi), _tagged(tmesh, grid, hi)
    assert np.array_equal(jm.vertices, tm.vertices)
    assert np.array_equal(jm.cells, tm.cells)
    assert jm.grid_shape == tm.grid_shape
    assert sorted(jm.facet_tags) == sorted(tm.facet_tags) == [1, 2, 3]
    for tag in jm.facet_tags:
        assert np.array_equal(jm.facet_tags[tag], tm.facet_tags[tag])

    js, ts = jspace.build_space(jm, degree), tspace.build_space(tm, degree)
    assert js.ndofs == ts.ndofs
    assert np.array_equal(js.dofmap, ts.dofmap)
    assert np.array_equal(js.dof_coords, ts.dof_coords)

    jw, jG = jgeom.volume_factors(jm, degree + 1)
    tw, tG = tgeom.volume_factors(tm, degree + 1)
    assert np.array_equal(jw, tw) and np.array_equal(jG, tG)
    for tag in jm.facet_tags:
        for a, b in zip(jgeom.facet_factors(jm, js, jm.facet_tags[tag]),
                        tgeom.facet_factors(tm, ts, tm.facet_tags[tag])):
            assert np.array_equal(a, b)
    assert jgeom.is_uniform_mesh(jm) and tgeom.is_uniform_mesh(tm)


@pytest.mark.parametrize("n", range(2, 10))
def test_gll_tables_match_jax(n):
    for a, b in zip(jgll.gll_points_weights_01(n), tgll.gll_points_weights_01(n)):
        assert np.array_equal(a, b)
    assert np.array_equal(jgll.diff_matrix(n), tgll.diff_matrix(n))
    pts = np.linspace(0.0, 1.0, 11)
    assert np.array_equal(jgll.lagrange_eval_gll(n, pts), tgll.lagrange_eval_gll(n, pts))


@pytest.mark.parametrize("grid,hi,degree", BOXES)
@pytest.mark.parametrize("hetero", [False, True])
def test_mass_and_facet_vectors_match_jax(grid, hi, degree, hetero):
    """Host assembly of the lumped mass and the boundary vectors (fp64)."""
    jm, tm = _tagged(jmesh, grid, hi), _tagged(tmesh, grid, hi)
    rng = np.random.default_rng(4)
    coeff = rng.uniform(0.5, 2.0, jm.num_cells) if hetero else 1.7
    jops = JaxOps(jm, degree, dtype=jnp.float64)
    tops = SEMOperators(tm, degree, dtype=torch.float64, device="cpu")
    assert tops.gdims == jops.lattice.gdims
    assert np.array_equal(np.asarray(jops.assemble_diag(coeff)), tops.assemble_diag(coeff))
    for tag in (1, 2, 3):
        assert np.array_equal(
            np.asarray(jops.facet_vector(tag, coeff)), tops.facet_vector(tag, coeff)
        )


@pytest.mark.parametrize("hetero", [False, True])
def test_rectangle_operators_match_jax(hetero):
    """A create_rectangle((4, 3)) lattice (which raised before the 2D
    lattices were ported): mass, facet vectors, stiffness diagonal and the
    stiffness apply (constant and DG-0, one and two fields) equal the JAX
    package's on the CPU in fp64."""
    jm, tm = (mod.create_rectangle((4, 3), (0, 0), (1.0, 0.6)) for mod in (jmesh, tmesh))
    for mod, m in ((jmesh, jm), (tmesh, tm)):
        mod.tag_boundaries(m, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12},
                           default=3)
    rng = np.random.default_rng(8)
    coeff = rng.uniform(0.5, 2.0, jm.num_cells) if hetero else 1.7
    jops = JaxOps(jm, 2, dtype=jnp.float64)
    tops = SEMOperators(tm, 2, dtype=torch.float64, device="cpu")
    assert tops.d == 2 and tops.gdims == jops.lattice.gdims == (9, 7)
    assert np.array_equal(np.asarray(jops.assemble_diag(coeff)), tops.assemble_diag(coeff))
    for tag in (1, 2, 3):
        assert np.array_equal(np.asarray(jops.facet_vector(tag, coeff)),
                              tops.facet_vector(tag, coeff))
    assert np.array_equal(np.asarray(jops.stiffness_diag(coeff)),
                          tops.stiffness_diag(coeff).numpy())
    x = rng.standard_normal((2, tops.ndofs))
    for n in (1, 2):
        cs = [coeff, 0.3][:n]
        y = tops.stiffness_apply([torch.from_numpy(v) for v in x[:n]],
                                 [tops.stiff_coeff(c) for c in cs]).numpy()
        jy = np.asarray(jops.stiffness_apply([jnp.asarray(v) for v in x[:n]],
                                             [jops.stiff_coeff(c) for c in cs]))
        assert np.max(np.abs(y - jy)) <= 1e-13 * np.max(np.abs(jy))


def test_unsupported_meshes_raise():
    """A bent box (a deformed lattice that is not bowl-fitted) no longer
    raises: it takes the general per-cell path, as in the JAX package, and
    its operators agree with the JAX package's to 1e-12."""
    meshes = []
    for mod in (tmesh, jmesh):
        bent = mod.create_box((3, 3, 3))
        bent.vertices = bent.vertices.copy()
        bent.vertices[:, 0] += 0.05 * bent.vertices[:, 1] ** 2
        bent.uniform_hint = False
        meshes.append(bent)
    tops = SEMOperators(meshes[0], 2, dtype=torch.float64, device="cpu")
    jops = JaxOps(meshes[1], 2, dtype=jnp.float64)
    assert tops.lattice is None and tops.hybrid is None and jops.lattice is None
    rng = np.random.default_rng(3)
    x = rng.standard_normal(tops.ndofs)
    coeff = rng.uniform(0.5, 2.0, tops.num_cells)
    y = tops.stiffness_apply([torch.from_numpy(x)], [tops.stiff_coeff(coeff)]).numpy()
    jy = np.asarray(jops.stiffness_apply([jnp.asarray(x)], [jops.stiff_coeff(coeff)]))
    assert np.max(np.abs(y - jy)) <= 1e-12 * np.max(np.abs(jy))
    jm = np.asarray(jops.assemble_diag(coeff))
    assert np.max(np.abs(tops.assemble_diag(coeff) - jm)) <= 1e-12 * np.max(jm)


def test_port_imports_no_jax():
    """Importing the port (with every example, experiment, MENDOUSSE, the
    speed and attribution tools and the PH1 SC1-BM1 and bowl convergence
    drivers) and ``chip_smoke.py`` imports no jax, nothing of the JAX
    package and nothing of ``examples/``, ``experiments/`` or
    ``benchmarks/``."""
    scripts = sorted(f"fenicsxfus_tpu_torch.{sub}.{f.stem}"
                     for sub in ("examples", "experiments")
                     for f in (REPO / "fenicsxfus_tpu_torch" / sub).glob("[!_]*.py"))
    assert len(scripts) == 28  # 23 examples (the sharded one included) and exp1-5
    tools = ", ".join(f"fenicsxfus_tpu_torch.tools.{t}" for t in (
        "operator_speed", "solver_speed", "stage_attrib", "hybrid_speed", "bounds",
        "setup_speed", "phase_breakdown", "wave_attrib", "unstructured_speed",
        "unstructured_trace", "bowl_blend_sweep", "bowl_spectrum"))
    tools += ", " + ", ".join(f"fenicsxfus_tpu_torch.drivers.{d}"
                              for d in ("ph1_sc1_bm1", "bowl_convergence"))
    code = (
        "import sys; import fenicsxfus_tpu_torch, fenicsxfus_tpu_torch.convert, "
        "fenicsxfus_tpu_torch._build, fenicsxfus_tpu_torch.analysis.error, "
        "fenicsxfus_tpu_torch.analysis.analytical, fenicsxfus_tpu_torch.utils, "
        "fenicsxfus_tpu_torch.models.lossy, fenicsxfus_tpu_torch.models.westervelt, "
        "fenicsxfus_tpu_torch.models.focused, fenicsxfus_tpu_torch.drivers.hitu, "
        "fenicsxfus_tpu_torch.ops.stage_ab, fenicsxfus_tpu_torch.ops.step_wave, "
        "fenicsxfus_tpu_torch.ops.cg, fenicsxfus_tpu_torch.core.conn, "
        "fenicsxfus_tpu_torch.tools.unstructured_solve, chip_smoke, "
        "fenicsxfus_tpu_torch.parallel, fenicsxfus_tpu_torch.parallel.runs, "
        "fenicsxfus_tpu_torch.parallel.dryrun, "
        f"fenicsxfus_tpu_torch.drivers.mendousse, {tools}, {', '.join(scripts)}; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fenicsxfus_tpu', 'examples', 'experiments', 'benchmarks')]; "
        "assert not bad, sorted(bad)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _box():
    return tmesh.create_box((2, 2, 2))


_MODEL_ARGS = dict(meshtags=None, degree=2, c0=1500.0, rho0=1000.0, freq0=0.5e6, p0=6e4,
                   s0=1500.0, rk_order=4, dt=1e-8)
# every entry point of the port that takes a device, called without one
ENTRY_POINTS = {
    "SEMOperators": lambda: SEMOperators(_box(), 2),
    "LinearSpectralExplicit": lambda: ft.LinearSpectralExplicit(_box(), **_MODEL_ARGS),
    "LossySpectralExplicit": lambda: ft.LossySpectralExplicit(_box(), delta0=0.0,
                                                              **_MODEL_ARGS),
    "WesterveltSpectralExplicit": lambda: ft.WesterveltSpectralExplicit(
        _box(), delta0=0.0, beta0=3.5, **_MODEL_ARGS),
    "WesterveltSpectralFocused": lambda: ft.WesterveltSpectralFocused(
        _box(), delta0=0.0, beta0=3.5, aperture_radius=0.2, focal_distance=0.6,
        **_MODEL_ARGS),
    "LinearSpectralImplicit": lambda: ft.LinearSpectralImplicit(_box(), **_MODEL_ARGS),
    "LossySpectralImplicit": lambda: ft.LossySpectralImplicit(_box(), delta0=0.0,
                                                              **_MODEL_ARGS),
    "hitu.build_model": lambda: hitu.build_model("W", "H101", "WATER", nx=4, degree=2),
    "pack_const": lambda: pack_const(LatticeStiffness((2, 2, 2), 2, (0.5,) * 3,
                                                      torch.float64), 1.0),
    "state_from_numpy": lambda: state_from_numpy(np.zeros(3), np.zeros(3)),
}
# the benchmark scripts' mains, each at a tiny size
BENCH_MAINS = {"tools.setup_speed": dict(nx=2), "tools.phase_breakdown": dict(nx=2),
               "tools.wave_attrib": dict(nx=2), "tools.unstructured_speed": dict(nx=2),
               "tools.unstructured_trace": dict(nx=2), "tools.bowl_blend_sweep": dict(nx=4),
               "tools.bowl_spectrum": dict(nx=4), "drivers.ph1_sc1_bm1": dict(nx=2),
               "drivers.bowl_convergence": dict(nx="2")}
ENTRY_POINTS.update({
    name: (lambda name=name, kw=kw: importlib.import_module(
        f"fenicsxfus_tpu_torch.{name}").main(**kw))
    for name, kw in BENCH_MAINS.items()})


def _cpu_model(cls):
    return cls(_box(), device="cpu", **{**_MODEL_ARGS, "rk_order": 2})


def _cpu_unstructured(cls):
    return cls(tmesh.as_unstructured(_box()), device="cpu", **{**_MODEL_ARGS, "rk_order": 2})


# the decompositions' entry points (no process group is needed to see the
# device refused: the device is resolved first)
ENTRY_POINTS.update({
    "parallel.ShardedExplicitSolver": lambda: parallel.ShardedExplicitSolver(
        _cpu_model(ft.LinearSpectralExplicit)),
    "parallel.ShardedImplicitSolver": lambda: parallel.ShardedImplicitSolver(
        _cpu_model(ft.LinearSpectralImplicit)),
    "parallel.build_sharded": lambda: parallel.build_sharded(
        lambda m: None, (2, 2, 2), (0, 0, 0), (1, 1, 1), 2, None, torch.float64),
    "parallel.spawn": lambda: parallel.spawn(print, 1),
    "parallel.ShardedExplicitSolver2D": lambda: parallel.ShardedExplicitSolver2D(
        _cpu_model(ft.LinearSpectralExplicit), (1, 1)),
    "parallel.ShardedImplicitSolverND": lambda: parallel.ShardedImplicitSolverND(
        _cpu_model(ft.LinearSpectralImplicit), (1, 1)),
    "parallel.build_sharded_grid": lambda: parallel.build_sharded_grid(
        lambda m: None, (2, 2, 2), (0, 0, 0), (1, 1, 1), 2, (1, 1), torch.float64),
    "parallel.ShardedUnstructuredExplicitSolver": lambda: parallel.ShardedUnstructuredExplicitSolver(
        _cpu_unstructured(ft.LinearSpectralExplicit)),
    "parallel.ShardedUnstructuredImplicitSolver": lambda: parallel.ShardedUnstructuredImplicitSolver(
        _cpu_unstructured(ft.LinearSpectralImplicit)),
    "parallel.dryrun_multichip": lambda: importlib.import_module(
        "fenicsxfus_tpu_torch.parallel.dryrun").dryrun_multichip(1),
    "examples.sharded_planewave3d": lambda: importlib.import_module(
        "fenicsxfus_tpu_torch.examples.sharded_planewave3d").main(nx=2, world=1),
})


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    """The port's entry points run on the card unless asked for the CPU:
    without CUDA, a call that names no device raises instead of falling
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ENTRY_POINTS[entry]()
