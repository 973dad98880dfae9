"""Oracles, error norms, timers, checkpoints and the public surface of the
PyTorch port, against the JAX package on the CPU (fp64):

* ``piston_axial_amplitude`` and the 2D scattering series
  (``SoundHardExact2D``, ``SoundSoftExact2D``, ``PenetrableExact2D``) equal
  to the JAX package's to 1e-13, and the four oracle checks of
  ``tests/test_scattering.py`` through the port;
* ``relative_h1_error`` and ``l2_norm`` on 1D/2D/3D lattices and an
  unstructured mesh, to 1e-13;
* ``analysis/timing.py`` (``Timer``, ``timeit_device``, ``list_timings``,
  ``reset_timings``; ``sync`` a no-op on the CPU);
* ``io/checkpoint.py``: a run split by a checkpoint equals the
  uninterrupted run to 1e-12, for a checkpoint written by either package
  and resumed in the other (``LinearSpectralExplicit``; Newmark with its
  ``w_n``), and an incompatible restore refuses;
* ``fenicsxfus_tpu_torch.__all__`` holds every public name of the JAX
  package's, the new entry points run on the card unless asked for the CPU,
  and neither the port nor ``chip_smoke.py`` imports jax or the JAX package.
"""

import ast
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
from fenicsxfus_tpu.analysis import analytical as jan
from fenicsxfus_tpu.analysis import error as jerr
from fenicsxfus_tpu.io import checkpoint as jck
from fenicsxfus_tpu.ops.operators import SEMOperators as JaxOps
import fenicsxfus_tpu_torch as ft
from fenicsxfus_tpu_torch.analysis import analytical as tan
from fenicsxfus_tpu_torch.analysis import error as terr
from fenicsxfus_tpu_torch.analysis.timing import (
    Timer,
    list_timings,
    reset_timings,
    sync,
    timeit_device,
)
from fenicsxfus_tpu_torch.io import checkpoint as tck
from fenicsxfus_tpu_torch.ops.operators import SEMOperators

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# ------------------------------------------------------------------ oracles

W0 = 2 * np.pi * 0.5e6
C0 = 1500.0
K0 = W0 / C0
A = 2 * np.pi / K0  # radius = one wavelength (ka = 2π)


def ring(r, n=64):
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    return np.stack([r * np.cos(th), r * np.sin(th)])


def _grid_points():
    """Points inside, on and outside the cylinder."""
    x = np.linspace(-3 * A, 3 * A, 23)
    X, Y = np.meshgrid(x, x + 0.1 * A, indexing="ij")
    return np.stack([X.reshape(-1), Y.reshape(-1)])


@pytest.mark.parametrize("name", ["SoundHardExact2D", "SoundSoftExact2D",
                                  "PenetrableExact2D", "PenetrableNoContrast"])
def test_scattering_series_match_jax(name):
    pts = _grid_points()
    if name.startswith("Penetrable"):
        rho1, c1 = (1000.0, C0) if name == "PenetrableNoContrast" else (1300.0, 1.25 * C0)
        args = (0.3e-6, W0, 1000.0, rho1, C0, c1, A)
        tex, jex = tan.PenetrableExact2D(*args), jan.PenetrableExact2D(*args)
    else:
        args = (0.3e-6, W0, K0, A)
        tex, jex = getattr(tan, name)(*args), getattr(jan, name)(*args)
        assert _rel(tex.scatter(pts.copy()), jex.scatter(pts.copy())) < 1e-13
    assert tex.nterms == jex.nterms
    assert _rel(tex.total(pts.copy()), jex.total(pts.copy())) < 1e-13
    assert _rel(tex.total_time_dependent(pts), jex.total_time_dependent(pts)) < 1e-13


def test_piston_axial_amplitude_matches_jax():
    z = np.linspace(0.0, 0.2, 401)
    a, k, p0 = 0.01, 2 * np.pi * 0.5e6 / 1500.0, 6e4
    amp = tan.piston_axial_amplitude(z, a, k, p0)
    assert _rel(amp, jan.piston_axial_amplitude(z, a, k, p0)) < 1e-13
    assert amp[0] == pytest.approx(2 * p0 * abs(np.sin(0.5 * k * a)), rel=1e-14)
    assert np.max(amp) <= 2 * p0 * (1 + 1e-15)


# tests/test_scattering.py's four oracle checks, through the port


def test_sound_hard_neumann_surface():
    """∂(total)/∂r = 0 on the cylinder surface (the defining BC)."""
    ex = ft.SoundHardExact2D(0.0, W0, K0, A)
    eps = 1e-6 * A
    up = ex.total(ring(A + 2 * eps))
    um = ex.total(ring(A + eps))
    dudr = np.abs(up - um) / eps
    scale = K0 * np.abs(ex.total(ring(2 * A))).max()
    assert dudr.max() / scale < 1e-3


def test_sound_soft_dirichlet_surface():
    """total = 0 on the cylinder surface."""
    ex = ft.SoundSoftExact2D(0.0, W0, K0, A)
    u = ex.total(ring(A * (1 + 1e-9)))
    scale = np.abs(ex.total(ring(2 * A))).max()
    assert np.abs(u).max() / scale < 1e-6


def test_penetrable_interface_continuity():
    """Pressure and normal velocity (1/ρ·∂p/∂r) continuous across r=a."""
    rho0, rho1, c1 = 1000.0, 1300.0, 1.25 * C0
    ex = ft.PenetrableExact2D(0.0, W0, rho0, rho1, C0, c1, A)
    eps = 1e-5 * A
    p_out = ex.total(ring(A + eps))
    p_in = ex.total(ring(A - eps))
    scale = np.abs(p_out).max()
    assert np.abs(p_out - p_in).max() / scale < 1e-3
    d_out = (ex.total(ring(A + 2 * eps)) - ex.total(ring(A + eps))) / eps
    d_in = (ex.total(ring(A - eps)) - ex.total(ring(A - 2 * eps))) / eps
    vscale = np.abs(d_out / rho0).max()
    assert np.abs(d_out / rho0 - d_in / rho1).max() / vscale < 2e-3


def test_penetrable_no_contrast_is_incident():
    """With ρ1=ρ0, c1=c0 the cylinder vanishes: total == e^{ik x}."""
    ex = ft.PenetrableExact2D(0.0, W0, 1000.0, 1000.0, C0, C0, A)
    pts = ring(1.7 * A)
    u = ex.total(pts)
    assert np.abs(u - np.exp(1j * K0 * pts[0])).max() < 1e-8


# ------------------------------------------------------------- error norms

NORM_MESHES = {
    "1d": ("create_interval", (6, 0.0, 1.0), False),
    "2d": ("create_rectangle", ((4, 3), (0, 0), (1.0, 0.7)), False),
    "3d": ("create_box", ((3, 2, 2), (0, 0, 0), (1.0, 0.6, 0.8)), False),
    "unstructured": ("create_rectangle", ((4, 3), (0, 0), (1.0, 0.7)), True),
}


@pytest.mark.parametrize("case", sorted(NORM_MESHES))
def test_error_norms_match_jax(case):
    name, args, unstructured = NORM_MESHES[case]
    meshes = []
    for mod in (ft, fus):
        mesh = getattr(mod, name)(*args)
        meshes.append(mod.as_unstructured(mesh) if unstructured else mesh)
    tops = SEMOperators(meshes[0], 3, dtype=torch.float64, device="cpu")
    jops = JaxOps(meshes[1], 3, dtype=jnp.float64)
    x = tops.space.dof_coords
    u = np.sin(2.0 * x[:, 0]) + 0.3 * x[:, -1] ** 2
    d = tops.d

    def grad(pts):  # the exact gradient of sin(2x0) + 0.3 x_{d-1}^2, but off by a bit
        g = np.zeros_like(pts)
        g[0] = 2.0 * np.cos(2.0 * pts[0])
        g[d - 1] += 0.6 * pts[d - 1] * 1.01
        return g

    for nq in (None, 6):
        h1 = terr.relative_h1_error(tops, torch.from_numpy(u), grad, nq)
        assert 0 < h1 < 0.1
        assert _rel(h1, jerr.relative_h1_error(jops, jnp.asarray(u), grad, nq)) < 1e-13
        l2 = terr.l2_norm(tops, torch.from_numpy(u), nq)
        assert _rel(l2, jerr.l2_norm(jops, jnp.asarray(u), nq)) < 1e-13
    assert terr.l2_norm(tops, u) == pytest.approx(terr.l2_norm(tops, torch.from_numpy(u)))


# ------------------------------------------------------------------ timing


def test_timers():
    reset_timings()
    with Timer("scope_a"):
        time.sleep(0.01)
    x = torch.ones(1000, dtype=torch.float64)
    with Timer("scope_b", result=x):
        x = x * 2.0
    t = timeit_device("dev_op", lambda a: a * 2.0, x, n=3)
    table = list_timings()
    assert "scope_a" in table and "scope_b" in table and "dev_op" in table
    assert t >= 0
    sync(x)  # CPU tensors: nothing to wait for
    sync(3.0)
    assert "scope_a" in list_timings(clear=True)
    assert "scope_a" not in list_timings()


# -------------------------------------------------------------- checkpoint


def _linear(mod, n):
    mesh = mod.create_interval(n, 0.0, 1.0)
    mod.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
    args = (mesh, None, 4, 1.0, 1.0, 10.0, 1.0, 1.0, 4, 1e-3)
    if mod is ft:
        return ft.LinearSpectralExplicit(*args, dtype=torch.float64, device="cpu")
    return fus.LinearSpectralExplicit(*args, dtype=jnp.float64)


def _newmark(mod):
    mesh = mod.create_interval(20, 0.0, 1.0)
    mod.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
    args = (mesh, None, 4, 1.0, 1.0, 10.0, 1.0, 1.0, 2e-3)
    if mod is ft:
        return ft.LinearSpectralNewmark(*args, device="cpu")
    return fus.LinearSpectralNewmark(*args, dtype=jnp.float64)


def _march(model, t0, tf):
    out = model.newmark(t0, tf) if hasattr(model, "newmark") else model.rk(t0, tf)
    return [np.asarray(x) for x in out[:-1]]


@pytest.mark.parametrize("kind", ["linear", "newmark"])
@pytest.mark.parametrize("writer, reader", [(ft, ft), (fus, ft), (ft, fus)])
def test_checkpoint_resume_across_packages(tmp_path, kind, writer, reader):
    """A run split by checkpoint/resume (written by ``writer``'s package,
    resumed in ``reader``'s) equals the uninterrupted run to 1e-12."""
    make = (lambda mod: _linear(mod, 20)) if kind == "linear" else _newmark
    full = make(reader).init()
    ref = _march(full, 0.0, 0.2)
    part = make(writer).init()
    _march(part, 0.0, 0.1)
    ckpt = tmp_path / "state.npz"
    (tck if writer is ft else jck).save_checkpoint(str(ckpt), part, extra={"note": 1})
    data = np.load(ckpt)
    assert set(data.files) >= {"u_n", "v_n", "t", "ndofs", "degree", "dim", "model"}
    assert ("w_n" in data.files) == (kind == "newmark")
    resumed = make(reader).init()
    t = (tck if reader is ft else jck).load_checkpoint(str(ckpt), resumed)
    assert t == pytest.approx(0.1, rel=1e-12)
    out = _march(resumed, t, 0.2)
    assert len(out) == len(ref) == (3 if kind == "newmark" else 2)
    for a, b in zip(out, ref):
        assert np.max(np.abs(b)) > 0 and _rel(a, b) < 1e-12


def test_checkpoint_refuses_incompatible(tmp_path):
    part = _linear(ft, 20).init()
    part.rk(0.0, 0.01)
    ckpt = tmp_path / "state.npz"
    tck.save_checkpoint(str(ckpt), part)
    with pytest.raises(ValueError, match="dofs"):
        tck.load_checkpoint(str(ckpt), _linear(ft, 10))
    with pytest.raises(ValueError, match="LinearSpectralNewmark"):
        mesh = ft.create_interval(20, 0.0, 1.0)
        tck.load_checkpoint(str(ckpt), ft.LinearSpectralNewmark(
            mesh, None, 4, 1.0, 1.0, 10.0, 1.0, 1.0, 1e-3, device="cpu"))
    resumed = _linear(ft, 20)
    tck.load_checkpoint(str(ckpt), resumed)
    assert resumed.u_n.dtype == torch.float64 and resumed.u_n.device.type == "cpu"
    assert torch.equal(resumed.u_n, part.u_n) and torch.equal(resumed.v_n, part.v_n)


# ---------------------------------------------------------- public surface


def test_all_is_a_superset_of_the_jax_packages():
    assert set(fus.__all__) <= set(ft.__all__), sorted(set(fus.__all__) - set(ft.__all__))
    for name in ft.__all__:
        assert hasattr(ft, name), name


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port and not ``chip_smoke.py`` imports jax, the JAX
    package or ``benchmarks/`` (read from their import statements), and importing the new
    modules leaves jax out of ``sys.modules``."""
    files = sorted((REPO / "fenicsxfus_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "fenicsxfus_tpu", "benchmarks"), (path, mod)
    code = (
        "import sys; import fenicsxfus_tpu_torch, fenicsxfus_tpu_torch.models.experimental, "
        "fenicsxfus_tpu_torch.ops.quadrature_ops, fenicsxfus_tpu_torch.analysis.timing, "
        "fenicsxfus_tpu_torch.io.checkpoint, fenicsxfus_tpu_torch.parallel, "
        "fenicsxfus_tpu_torch.parallel.runs, fenicsxfus_tpu_torch.examples.sharded_planewave3d; "
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'fenicsxfus_tpu')], "
        "sorted(m for m in sys.modules if 'jax' in m)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _interval():
    mesh = ft.create_interval(4, 0.0, 1.0)
    ft.tag_boundaries(mesh, {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1 - 1e-12})
    return mesh


NEW_ENTRY_POINTS = {
    "LinearExplicit": lambda: ft.LinearExplicit(_interval(), None, 2, 1.0, 1.0, 10.0, 1.0,
                                                1.0, 4, 1e-3),
    "LinearSpectralNewmark": lambda: ft.LinearSpectralNewmark(
        _interval(), None, 2, 1.0, 1.0, 10.0, 1.0, 1.0, 1e-3),
    "LinearSpectralS2": lambda: ft.LinearSpectralS2(_interval(), None, 2, 1.0, 1.0, 10.0,
                                                    1.0, 1.0),
    "LinearSpectralSponge": lambda: ft.LinearSpectralSponge(
        _interval(), None, 2, 1.0, 1.0, 1e-3, 10.0, 1.0, 1.0),
    "LinearSpectralAdaptive": lambda: ft.LinearSpectralAdaptive(
        _interval(), None, 2, 1.0, 1.0, 10.0, 1.0, 1.0),
    "WesterveltSpectralAdaptive": lambda: ft.WesterveltSpectralAdaptive(
        _interval(), None, 2, 1.0, 1.0, 0.0, 0.01, 10.0, 1.0, 1.0),
}


@pytest.mark.parametrize("entry", sorted(NEW_ENTRY_POINTS))
def test_new_entry_points_default_to_the_card(entry):
    """Without CUDA, a model built without naming a device raises instead
    of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        NEW_ENTRY_POINTS[entry]()
