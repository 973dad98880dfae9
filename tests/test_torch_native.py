"""The port's native geometry library (``fenicsxfus_tpu_torch/native/``)
against the port's numpy path and the JAX package's ``quadrature_factors``
on jittered meshes; its build under concurrent processes, with no g++ and
with a failing compile; and the ``FUS_NATIVE=0`` switch of
``core/geometry.py::quadrature_factors``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from fenicsxfus_tpu.core import mesh as jmesh
from fenicsxfus_tpu.core.geometry import quadrature_factors as jax_quadrature_factors
from fenicsxfus_tpu_torch import native
from fenicsxfus_tpu_torch.core import geometry as tgeom
from fenicsxfus_tpu_torch.core import mesh as tmesh
from fenicsxfus_tpu_torch.core.gll import gll_points_weights_01


def _jittered(mod, dim):
    """The JAX package's ``tests/test_native.py`` meshes: interior vertices
    moved by up to 0.015 in each coordinate (``default_rng(0)``)."""
    mesh = {1: lambda: mod.create_interval(9), 2: lambda: mod.create_rectangle((5, 4)),
            3: lambda: mod.create_box((4, 3, 2))}[dim]()
    rng = np.random.default_rng(0)
    v = mesh.vertices
    lo, hi = v.min(axis=0), v.max(axis=0)
    interior = np.all((v > lo + 1e-12) & (v < hi - 1e-12), axis=1)
    v[interior] += 0.03 * (rng.random((interior.sum(), dim)) - 0.5)
    mesh.uniform_hint = False
    return mesh


def _close(a, b, rtol):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_native_matches_numpy_and_jax(dim, monkeypatch):
    """From ``PARALLEL_CELLS`` cells the factors come from the native
    library, within 1e-13 of the port's numpy path and the JAX package's."""
    x1, w1 = gll_points_weights_01(5)
    mesh = _jittered(tmesh, dim)
    ref_np = tgeom.quadrature_factors(mesh, x1, w1)  # below PARALLEL_CELLS: numpy
    ref_jax = jax_quadrature_factors(_jittered(jmesh, dim), x1, w1)
    monkeypatch.setattr(tgeom, "PARALLEL_CELLS", 1)
    got = tgeom.quadrature_factors(mesh, x1, w1)
    for a, b, c in zip(got, ref_np, ref_jax):
        assert a.shape == b.shape and a.dtype == np.float64
        _close(a, b, 1e-13)
        _close(a, c, 1e-13)


def test_native_is_the_library_and_fus_native_0_the_workers(monkeypatch):
    """Above the threshold the result is ``native.volume_factors``' bit for
    bit; under ``FUS_NATIVE=0`` it is the chunked workers' (the JAX
    package's numpy bits)."""
    x1, w1 = gll_points_weights_01(4)
    mesh = _jittered(tmesh, 3)
    monkeypatch.setattr(tgeom, "PARALLEL_CELLS", 1)
    monkeypatch.setattr(tgeom, "CHUNK_CELLS", 5)
    got = tgeom.quadrature_factors(mesh, x1, w1)
    grids = np.meshgrid(x1, x1, x1, indexing="ij")
    qpts = np.stack([g.reshape(-1) for g in grids], axis=-1)
    w = np.multiply.outer(np.multiply.outer(w1, w1).reshape(-1), w1).reshape(-1)
    lib = native.volume_factors(mesh.cell_vertices(), qpts, w)
    for a, b in zip(got, lib):
        assert np.array_equal(a, b)
    monkeypatch.setenv("FUS_NATIVE", "0")
    assert not native.enabled()
    workers = tgeom.quadrature_factors(mesh, x1, w1)
    ref = jax_quadrature_factors(_jittered(jmesh, 3), x1, w1)
    for a, b in zip(workers, ref):
        assert np.array_equal(a, b)


def test_native_degenerate_cells_raise(monkeypatch):
    mesh = _jittered(tmesh, 3)
    mesh = tmesh.Mesh(dim=3, vertices=np.zeros_like(mesh.vertices), cells=mesh.cells)
    monkeypatch.setattr(tgeom, "PARALLEL_CELLS", 1)
    x1, w1 = gll_points_weights_01(3)
    with pytest.raises(ValueError, match="degenerate"):
        tgeom.quadrature_factors(mesh, x1, w1)


_LOAD = """
import ctypes, importlib.util, sys
spec = importlib.util.spec_from_file_location("fus_native", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
path = mod.build(sys.argv[2])
ctypes.CDLL(str(path)).fus_volume_factors
print(path)
"""


def test_concurrent_processes_share_one_build(tmp_path):
    """Six processes that find an empty build directory at the same moment
    all load the library: one compiles, the others wait on the lock and
    load its result; no temporary file is left behind."""
    init = native.__file__
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, init, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    libs = sorted(f.name for f in tmp_path.iterdir() if f.suffix != ".lock")
    assert libs == [os.path.basename(paths.pop())]


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.build(tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "geometry.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g.. failed"):
        native.build(tmp_path / "build")
    assert not [f for f in (tmp_path / "build").iterdir() if f.suffix != ".lock"]


def test_fus_native_is_read_at_every_call(monkeypatch):
    monkeypatch.delenv("FUS_NATIVE", raising=False)
    assert native.enabled()
    monkeypatch.setenv("FUS_NATIVE", "0")
    assert not native.enabled()
    monkeypatch.setenv("FUS_NATIVE", "1")
    assert native.enabled()


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="shapes"):
        native.volume_factors(np.zeros((2, 4, 3)), np.zeros((5, 3)), np.ones(5))
