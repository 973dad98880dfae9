"""The port's examples (``fenicsxfus_tpu_torch/examples/``) against the JAX
package's scripts (``examples/``): each script's ``main`` and its port's on
the same small problem (the script's own size arguments), both in fp64, the
port on the CPU. The JAX scripts return little, so the model methods they
call (``rk``, ``rk_record``, ``dirk``, ``newmark``) are wrapped here to record
their results. Final fields and sensor traces agree to 1e-9 (relative
max-norm), every printed number to 1e-9, CG iteration counts exactly.
Output files go under ``tmp_path``.
"""

import importlib
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu
from fenicsxfus_tpu.analysis import error as jerror
from fenicsxfus_tpu.analysis.analytical import oneil_axial_amplitude
from fenicsxfus_tpu.models import base as jbase
from fenicsxfus_tpu.models import experimental as jexp

torch.set_num_threads(1)

TOL = 1e-9


def rel(a, b) -> float:
    """max|a - b| / max|b| of two fields (arrays or tensors)."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def close(a, b) -> bool:
    return abs(a - b) <= TOL * max(abs(b), 1e-300)


@pytest.fixture
def jax_runs(monkeypatch):
    """The JAX models' time marches during a test, as (model, result) in
    call order."""
    runs = []

    def wrap(cls, name):
        orig = getattr(cls, name)

        def recorded(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            runs.append((self, out))
            return out

        monkeypatch.setattr(cls, name, recorded)

    for cls, name in ((jbase.ExplicitModelBase, "rk"), (jbase.ExplicitModelBase, "rk_record"),
                      (jbase.ImplicitModelBase, "dirk"),
                      (jexp.LinearSpectralNewmark, "newmark")):
        wrap(cls, name)
    return runs


def run_both(name, jax_runs, tmp_path=None, **kwargs):
    """Run the JAX script and its port with ``kwargs`` (and, where the script
    writes files, ``out`` under ``tmp_path``); hold the port's final field
    and time to the JAX run's. Returns (the JAX script's return, the JAX
    model and result of its last march, the port's dict)."""
    jmain = importlib.import_module(f"examples.{name}").main
    pmain = importlib.import_module(f"fenicsxfus_tpu_torch.examples.{name}").main
    if tmp_path is not None and "out" in inspect.signature(jmain).parameters:
        kwargs["out"] = str(tmp_path / name)
    jret = jmain(**kwargs)
    jmodel, jout = jax_runs[-1]
    port = pmain(device="cpu", **kwargs)
    assert port["model"].dtype == torch.float64 and port["u"].device.type == "cpu"
    assert rel(port["u"], jout[0]) <= TOL
    assert close(port["t"], float(jout[3] if len(jout) == 4 else jout[2]))
    for path in port.get("paths", []):
        assert os.path.exists(path), path
    return jret, jmodel, jout, port


# (script, its size arguments, the port dict's numbers recomputed from the
# JAX run: name -> f(JAX script's return, JAX model, JAX final u))
def _max(u):
    return float(np.abs(np.asarray(u)).max())


def _region(axis, keep):
    return lambda ret, m, u: _max(np.asarray(u)[keep(m.ops.space.dof_coords[:, axis])])


def _axial(ret, m, u):
    xs = np.linspace(0.005, 0.12 - 0.005, 24)
    return fenicsxfus_tpu.eval_function(m.ops, u, np.stack([xs, 0 * xs]))[1]


MAX_U = {"max_u": lambda ret, m, u: _max(u)}
LINE = {"max_u": lambda ret, m, u: _max(ret[1]), "u_line": lambda ret, m, u: ret[1]}
WINDOW = {"on_axis": _region(1, lambda y: np.abs(y) < 0.011 / 2),
          "off_axis": _region(1, lambda y: np.abs(y) > 0.12 / 3)}
EXPLICIT = [
    ("linear_planewave1d", dict(epw=1, degree=2), LINE),
    ("linear_planewave1d", dict(epw=1, degree=2, hetero=True), LINE),
    ("westervelt_planewave1d", dict(epw=1, degree=2), LINE),
    ("linear_planewave2d", dict(epw=1, degree=2), MAX_U),
    ("linear_planar2d", dict(epw=1, degree=2), MAX_U),
    ("lossy_planewave2d", dict(epw=1, degree=2), MAX_U),
    ("westervelt_planewave2d", dict(epw=1, degree=2), MAX_U),
    ("westervelt_planar2d", dict(epw=1, degree=1),
     {"axial": _axial, "max_axial": lambda ret, m, u: _max(_axial(ret, m, u))}),
    ("lossy_planar2d_heterogeneous", dict(epw=1, degree=1),
     {"in_bone": _region(0, lambda x: x > 0.06 + 0.01),
      "in_water": _region(0, lambda x: x < 0.06 - 0.01)}),
    ("westervelt_planar2d_heterogeneous", dict(epw=1, degree=1),
     {"before": _region(0, lambda x: x < 0.03 - 0.005),
      "after": _region(0, lambda x: x > 0.0365 + 0.005)}),
    ("linear_planewave2d_windowed", dict(epw=1, degree=2), WINDOW),
    ("linear_planewave2d_windowed", dict(epw=1, degree=2, window="tukey"), WINDOW),
    ("linear_planewave2d_sponge", dict(epw=1, degree=1), MAX_U),
]


@pytest.mark.parametrize("name,kwargs,numbers", EXPLICIT,
                         ids=[f"{c[0]}-{'-'.join(map(str, c[1].values()))}" for c in EXPLICIT])
def test_explicit_example_matches_jax(name, kwargs, numbers, jax_runs, tmp_path,
                                      monkeypatch):
    monkeypatch.chdir(tmp_path)  # the JAX scripts write their files into the cwd
    ret, jmodel, jout, port = run_both(name, jax_runs, tmp_path, **kwargs)
    for key, f in numbers.items():
        want = f(ret, jmodel, jout[0])
        assert (rel(port[key], want) <= TOL if np.ndim(want) else close(port[key], want)), key


IMPLICIT = [
    ("linear_planewave1d_imp", dict(epw=1, degree=2)),
    ("linear_planewave2d_imp", dict(epw=1, degree=2)),
    ("linear_planar2d_imp", dict(epw=1, degree=2)),
    ("lossy_planewave2d_imp", dict(epw=1, degree=2)),
    ("lossy_planar2d_imp", dict(epw=1, degree=2)),
]


@pytest.mark.parametrize("name,kwargs", IMPLICIT, ids=[c[0] for c in IMPLICIT])
def test_implicit_example_matches_jax(name, kwargs, jax_runs, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, jmodel, _, port = run_both(name, jax_runs, tmp_path, **kwargs)
    assert port["cg_max_iterations"] == jmodel.cg_stats["max_iterations"]
    if "cg_max_residual2" in port:
        assert np.isclose(port["cg_max_residual2"], float(jmodel.cg_stats["max_residual2"]),
                          rtol=1e-6, atol=0.0)


def test_newmark_example_matches_jax(jax_runs, monkeypatch):
    errs = []
    orig = jerror.relative_l2_error
    monkeypatch.setattr(jerror, "relative_l2_error",
                        lambda *a, **k: errs.append(float(orig(*a, **k))) or errs[-1])
    _, _, _, port = run_both("linear_planewave1d_newmark", jax_runs, epw=4, degree=3)
    assert close(port["err"], errs[-1]) and port["err"] < 5e-2


def test_scattering_example_matches_jax(jax_runs):
    err, _, jout, port = run_both("linear_scattering2d", jax_runs, epw=2, degree=2)
    assert rel(port["ys"], np.asarray(jout[4])) <= TOL
    assert close(port["err"], float(err))


def _float64_class(monkeypatch, name):
    """Make the JAX package's model class ``name`` (as the scripts import it)
    build in fp64, whatever dtype the script passes."""
    cls = getattr(fenicsxfus_tpu, name)

    class F64(cls):
        def __init__(self, *args, **kwargs):
            kwargs["dtype"] = jnp.float64
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(fenicsxfus_tpu, name, F64)


def test_planewave3d_example_matches_jax(jax_runs, monkeypatch):
    """The JAX script is fp32 on every backend: both run it in fp64 here."""
    _float64_class(monkeypatch, "LinearSpectralExplicit")
    jmain = importlib.import_module("examples.linear_planewave3d").main
    from fenicsxfus_tpu_torch.examples.linear_planewave3d import main

    jmain(nx=4, degree=2)
    jm, (u, _, t) = jax_runs[-1]
    assert jm.dtype == jnp.float64
    port = main(nx=4, degree=2, dtype=torch.float64, device="cpu")
    assert port["model"].step_kind == "fused"
    assert rel(port["u"], u) <= TOL and close(port["t"], t)
    assert close(port["max_u"], float(jnp.max(jnp.abs(u))))


def test_bowl3d_example_matches_jax(jax_runs):
    _, jm, jout, port = run_both("linear_bowl3d", jax_runs, nx=12, degree=2)
    assert port["hybrid"] and jm.ops.hybrid is not None
    assert rel(port["ys"], np.asarray(jout[4])) <= TOL
    amp = np.max(np.abs(np.asarray(jout[4])), axis=0)
    f0, c0, a, roc = 0.25e6, 1500.0, 0.032, 0.0632
    xs = np.linspace(0.02, 0.11, 61)
    ref = oneil_axial_amplitude(xs + roc - np.sqrt(roc**2 - a**2), a, roc,
                                2 * np.pi * f0 / c0, 60000.0)
    gain = abs(amp.max() - ref.max()) / ref.max()
    assert close(port["gain_err"], gain) and rel(port["amp"], amp) <= TOL


@pytest.mark.parametrize("name,model", [("linear_from_reference_mesh", "LinearSpectralExplicit"),
                                        ("linear_planewave2d_sponge_unstructured",
                                         "LinearSpectralSponge")])
def test_reference_mesh_examples_match_jax(name, model, jax_runs, tmp_path, monkeypatch):
    """Both scripts read the reference's mesh (the JAX script from its
    ``MESH``, the port from its ``mesh`` argument); here a DOLFINx-layout
    file written by the test (a jittered unstructured quad mesh) takes its
    place in both packages. Without a mesh both skip alike."""
    from test_torch_xdmf import _dolfinx_files

    jmod = importlib.import_module(f"examples.{name}")
    pmod = importlib.import_module(f"fenicsxfus_tpu_torch.examples.{name}")
    if not os.path.exists(jmod.MESH):
        jmod.main()
        assert not jax_runs
    assert pmod.main(device="cpu") is None
    path, _, _ = _dolfinx_files(tmp_path, 2)
    monkeypatch.setattr(jmod, "MESH", path)
    jmod.main()
    jm, jout = jax_runs[-1]
    assert type(jm).__name__ == model and jm.ops.lattice is None
    port = pmod.main(mesh=path, device="cpu")
    assert rel(port["u"], jout[0]) <= TOL and float(port["u"].abs().max()) > 0
