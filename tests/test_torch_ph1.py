"""The port's PH1 driver (``fenicsxfus_tpu_torch/drivers/ph1.py``) against
the JAX package's ``benchmarks/ph1/common.py`` and ``validate.py`` (loaded
as ``tests/test_ph1.py`` and ``tests/test_ph1_validation.py`` load them):
the constants and the DG-0 media bit for bit, every (sc, bm) model built at
small nx in fp64 on the CPU (dt, steps per period, 5 RK4 steps to 1e-10;
the SC2 bowl-fitted model is held in ``tests/test_torch_hitu_cases.py``
beside the other bowl-fitted source), a short ``run`` and ``convergence``
against the JAX runs (1e-10), and the validation functions on the committed
artifacts (1e-12).
"""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.ph1 import validate as jval
from fenicsxfus_tpu_torch.drivers import hitu, ph1

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "benchmarks", "ph1", "results")
_spec = importlib.util.spec_from_file_location(
    "ph1_common", os.path.join(ROOT, "benchmarks", "ph1", "common.py"))
jph1 = importlib.util.module_from_spec(_spec)
sys.modules["ph1_common"] = jph1
_spec.loader.exec_module(jph1)

NX = 16  # h = 7.5 mm: the centroids reach skin (26.25 mm) and trabecular (33.75 mm)
NX_MODEL = 12  # h = 10 mm: the centroids at 35 mm are trabecular or cortical bone


def test_constants_match_jax():
    for name in ("F0", "P0", "W0", "DOMAIN_L", "DOMAIN_W", "SC1_RADIUS", "SC2_APERTURE",
                 "SC2_ROC", "MATERIALS", "CURVE_ROC", "BM_LAYERS", "BM_CURVED",
                 "BM_BACKGROUND", "BM_DEGREE"):
        assert getattr(ph1, name) == getattr(jph1, name), name


@pytest.mark.parametrize("nx", [NX, 48])
def test_build_media_bit_for_bit(nx):
    """The DG-0 media of BM1-7 equal the JAX package's bit for bit, on the
    mesh of ``build_mesh`` (flat and curved layers) and on the bowl-fitted
    mesh."""
    mesh, h = ph1.build_mesh(nx, 4)
    jmesh, jh = jph1.build_mesh(nx, 4)
    assert h == jh
    np.testing.assert_array_equal(mesh.vertices, jmesh.vertices)
    for bm in range(1, 8):
        for a, b in zip(ph1.build_media(mesh, bm), jph1.build_media(jmesh, bm)):
            np.testing.assert_array_equal(a, b)
    c0, _, _ = ph1.build_media(mesh, 6)
    assert {1500.0, 1610.0, 2300.0} <= set(np.unique(c0))


def test_tag_scenario_leaves_the_baffle_untagged():
    """Tag 1 is the source disc and tag 2 the five outer faces; the rest of
    the x = 0 plane has no tag (natural Neumann), as in the JAX package."""
    for sc in (1, 2):
        mesh, _ = ph1.build_mesh(NX, 4)
        jmesh, _ = jph1.build_mesh(NX, 4)
        ph1.tag_scenario(mesh, sc)
        jph1.tag_scenario(jmesh, sc)
        assert sorted(mesh.facet_tags) == sorted(jmesh.facet_tags) == [1, 2]
        for t in (1, 2):
            np.testing.assert_array_equal(mesh.facet_tags[t], jmesh.facet_tags[t])
        x0 = np.sum(mesh.facet_tags[2][:, 1] == 0)
        assert x0 == 0  # no x = 0 facet is an ABC facet


def _five_steps(sc, bm, nx, bowl=False):
    model, mesh, h, dt, spp = ph1.build_model(sc, bm, nx, dtype=torch.float64, bowl=bowl,
                                              device="cpu")
    jm, jmesh, jh, jdt, jspp = jph1.build_model(sc, bm, nx, dtype=jnp.float64, bowl=bowl)
    assert (h, dt, spp) == (jh, jdt, jspp)
    assert model.number_of_dofs() == jm.number_of_dofs()
    model.rk(0.0, 5 * dt)
    jm.rk(0.0, 5 * jdt)
    u = model.u_n.reshape(-1).numpy()
    ref = np.asarray(jm.u_n)
    assert np.max(np.abs(ref)) > 0
    assert np.max(np.abs(u - ref)) <= 1e-10 * np.max(np.abs(ref))
    return model


@pytest.mark.parametrize("sc,bm", ph1.CASES)
def test_models_match_jax(sc, bm):
    model = _five_steps(sc, bm, NX_MODEL)
    kind = {1: "linear" if bm == 1 else "lossy", 2: "focused"}[sc]
    assert model.step_kind == "fused" and type(model).FUSED_KIND == kind
    assert model.degree == ph1.BM_DEGREE[bm]


def test_short_run_matches_jax(tmp_path):
    """``run`` of SC1-BM3 (a flat bone layer) at the size of the JAX
    package's smoke test, fp64, with its artifact: the same axial amplitude
    (1e-10) and the JAX package's keys."""
    kw = dict(nx=12, final_time=6.0e-6)
    x_ref, amp_ref = jph1.run(1, 3, dtype=jnp.float64, **kw)
    out = str(tmp_path / "r.npz")
    res = ph1.run(1, 3, dtype=torch.float64, device="cpu", out=out, **kw)
    np.testing.assert_array_equal(res.x, x_ref)
    assert res.nsteps == len(res.times) and res.ys.shape == (res.nsteps, 121)
    assert np.max(np.abs(res.amplitude - amp_ref)) <= 1e-10 * np.max(np.abs(amp_ref))
    d = np.load(out)
    assert sorted(d.files) == ["amplitude", "meta", "sensor_x", "times", "waveforms", "x"]
    meta = json.loads(str(d["meta"]))
    assert (meta["sc"], meta["bm"], meta["nx"], meta["mesh"]) == (1, 3, 12, "flat-phased")
    # a run held against itself passes the committed-run gate
    assert hitu.check_artifact(res, out)["ok"]


def test_snapped_sensors_are_the_nearest_nodes():
    """``snap=True`` records each axial sensor at its nearest DOF node (the
    sampling of the committed runs): the amplitude equals the interpolated
    run's at the node-aligned sensors and the nodal field's elsewhere."""
    kw = dict(nx=12, final_time=6.0e-6, dtype=torch.float64, device="cpu")
    interp = ph1.run(1, 1, **kw)
    snapped = ph1.run(1, 1, snap=True, **kw)
    np.testing.assert_array_equal(snapped.x, interp.x)
    model = snapped.model
    idx = model.sensor_indices(ph1.axial_points())
    nodes = model.ops.dof_coords()[idx]
    on_node = np.abs(nodes[:, 0] - snapped.x) < 1e-12
    assert 0 < on_node.sum() < len(on_node)
    np.testing.assert_allclose(snapped.amplitude[on_node], interp.amplitude[on_node],
                               rtol=1e-12, atol=0)
    assert np.max(np.abs(snapped.amplitude - interp.amplitude)) > 1e-3 * np.max(
        interp.amplitude)
    np.testing.assert_array_equal(snapped.ys[-1], model.u_n.reshape(-1)[idx].numpy())


def test_convergence_and_stationarity_match_jax(monkeypatch):
    """``convergence`` against the JAX driver (1e-10 on each number), and
    ``tf_stationarity`` over the profiles cache: each profile runs once."""
    got = ph1.convergence(1, 2, 8, 10, dtype=torch.float64, tf=4e-6, device="cpu")
    ref = jval.convergence(1, 2, 8, 10, dtype=jnp.float64, tf=4e-6)
    for k in ("nx", "nx_fine"):
        assert got[k] == ref[k]
    for k in ("profile_l2", "peak_rel"):
        assert abs(got[k] - ref[k]) <= 1e-10 * abs(ref[k]) + 1e-14
    monkeypatch.setattr(ph1, "default_final_time", lambda: 3e-6)
    calls = []
    build = ph1.build_model
    monkeypatch.setattr(ph1, "build_model", lambda *a, **k: calls.append(a) or build(*a, **k))
    profiles = {}
    st = ph1.tf_stationarity(1, 1, 8, extra_periods=1, dtype=torch.float64, device="cpu",
                             profiles=profiles)
    again = ph1.tf_stationarity(1, 1, 8, extra_periods=1, dtype=torch.float64, device="cpu",
                                profiles=profiles)
    assert len(calls) == 2 and len(profiles) == 2 and st == again
    (xa, a), (_, b) = profiles.values()
    sel = xa > 0.005
    assert st["profile_l2"] == pytest.approx(
        np.linalg.norm((a - b)[sel]) / np.linalg.norm(b[sel]), rel=1e-15)


def _artifact(sc, bm):
    d = np.load(os.path.join(RESULTS, f"sc{sc}_bm{bm}.npz"))
    return d["x"].astype(np.float64), d["amplitude"].astype(np.float64)


def _same(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.all(np.abs(a - b) <= 1e-12 * np.maximum(np.abs(b), 1e-300)), (a, b)


def test_transmission_functions_match_jax():
    for bm in range(1, 8):
        _same(ph1.transmission_1d(bm), jval.transmission_1d(bm))
    stacks = [[], [(2800.0, 1850.0, 0.0, 0.0123)], [(2800.0, 1850.0, 46.0, 0.0065),
                                                     (1610.0, 1090.0, 2.3, 0.004)]]
    for st in stacks:
        _same(ph1.transmission_stack(st), jval.transmission_stack(st))
        _same(ph1.transmission_stack(st, w0=2e6, Z_outer=1.2e6),
              jval.transmission_stack(st, w0=2e6, Z_outer=1.2e6))
    xw, aw = _artifact(1, 1)
    for bm in range(1, 8):
        x, amp = _artifact(1, bm)
        got = ph1.transmission_check(1, bm, x, amp, xw, aw)
        ref = jval.transmission_check(1, bm, x, amp, xw, aw)
        assert (got is None) == (ref is None)
        if got is not None:
            assert got["pass"] == ref["pass"] and got["tol"] == ref["tol"]
            for k in ("measured", "predicted", "rel"):
                _same(got[k], ref[k])
    # the committed SC1-BM4 run passes the gate of its stamp (tol 0.35)
    got = ph1.transmission_check(1, 4, *_artifact(1, 4), xw, aw)
    stamp = json.load(open(os.path.join(RESULTS, "validation_sc1_bm4.json")))
    assert got["pass"] and got["tol"] == stamp["transmission_1d"]["tol"]


def test_focal_functions_match_jax():
    for sc, bm in ph1.CASES:
        x, amp = _artifact(sc, bm)
        for lo in (0.005, 0.0):
            _same(ph1.focal_metrics(x, amp, lo), jval.focal_metrics(x, amp, lo))
    for sc in (1, 2):
        z = np.linspace(0.0, 0.12, 2001)
        for alpha in (0.0, 11.5):
            _same(ph1._complex_axial_amplitude(z, sc, alpha),
                  jval._complex_axial_amplitude(z, sc, alpha))
        for bm in range(1, 8):
            got, ref = ph1.focal_reference(sc, bm), jval.focal_reference(sc, bm)
            assert (got is None) == (ref is None)
            if got is not None:
                for k in ("focal_p", "focal_x", "ext6"):
                    _same(got[k], ref[k])


def test_steady_amplitude_and_points_match_jax():
    rng = np.random.default_rng(2)
    times = np.cumsum(np.full(400, 3e-8))
    ys = rng.standard_normal((400, 121))
    np.testing.assert_array_equal(ph1.steady_amplitude(times, ys),
                                  jph1.steady_amplitude(times, ys))
    np.testing.assert_array_equal(ph1.axial_points(), jph1.axial_points())


def test_cli_arguments(monkeypatch, tmp_path):
    """``--all`` runs the 14 cases in order and writes ``DIR/sc*_bm*.npz``;
    a case that fails raises and ends the sweep; a focal peak that misses
    its committed run ends the CLI with an error after the sweep."""
    for argv in (["--sc", "1"], ["--all", "--sc", "1", "--bm", "1"], ["--all", "--bowl"], []):
        with pytest.raises(SystemExit):
            ph1.main(argv)
    seen = []

    def fake_run(sc, bm, nx, out, bowl, device, dtype, snap):
        assert dtype == torch.float32 and not bowl
        seen.append((sc, bm, nx, out, device, snap))
        if (sc, bm) == (2, 3):
            raise RuntimeError("case failed")
        x, amp = _artifact(sc, bm)
        return ph1.Ph1Run(x, amp * (1.1 if (sc, bm) == (1, 2) else 1.0), None, 0.0, 0.0, 0,
                          None, None)

    monkeypatch.setattr(ph1, "run", fake_run)
    with pytest.raises(RuntimeError, match="case failed"):
        ph1.main(["--all", "--nx", "8", "--out", str(tmp_path), "--device", "cpu"])
    assert [s[:2] for s in seen] == ph1.CASES[:10]
    assert seen[0][3] == str(tmp_path / "sc1_bm1.npz") and seen[0][2] == 8
    seen.clear()
    with pytest.raises(SystemExit, match="SC1-BM2"):
        ph1.main(["--sc", "1", "--bm", "2", "--check", RESULTS, "--device", "cpu"])
    ph1.main(["--sc", "2", "--bm", "7", "--check", RESULTS, "--device", "cpu", "--snap"])
    assert seen[-1] == (2, 7, 80, None, "cpu", True)
