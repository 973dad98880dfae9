"""The HITU production surface of the port against the JAX package: each
HITU variant's model (``drivers/hitu.py::build_model``), and PH1's SC2 on
the bowl-fitted mesh, at small nx in fp64 on the CPU against the JAX
package's ``build_model`` (dt, steps per period, 5 RK4 steps to 1e-10), a short ``full=True`` run and the H131 O'Neil check against the JAX
driver's, ``check_artifact`` and the ``--check`` command line,
``drivers/harmonics.py`` against ``benchmarks/hitu/harmonics.py`` on the
committed runs (1e-12), and ``tools/fp32_drift.py`` against
``benchmarks/fp32_drift.py`` (the fp64 run at 250 steps to 1e-10, the table
format and the gates).
"""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsxfus_tpu_torch.drivers import harmonics, hitu
from fenicsxfus_tpu_torch.tools import fp32_drift

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HITU_DIR = os.path.join(ROOT, "benchmarks", "hitu")
RESULTS = os.path.join(HITU_DIR, "results")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


jax_hitu = _load("hitu_common", os.path.join(HITU_DIR, "common.py"))
jax_drift = _load("fp32_drift_jax", os.path.join(ROOT, "benchmarks", "fp32_drift.py"))

VARIANTS = [("W", "H101", "WATER"), ("W", "H101", "LIVER"), ("W", "H131", "WATER"),
            ("W", "H131", "LIVER"), ("V", "H131", "WATER")]


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.max(np.abs(a - b)) <= rtol * max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("kind,tx,medium", VARIANTS)
def test_variant_models_match_jax(kind, tx, medium):
    kw = dict(nx=8, degree=2, f0=0.5e6)
    model, h, dt, spp = hitu.build_model(kind, tx, medium, dtype=torch.float64, device="cpu",
                                         **kw)
    jm, jh, jdt, jspp = jax_hitu.build_model(kind, tx, medium, dtype=jnp.float64, **kw)
    assert (h, dt, spp) == (jh, jdt, jspp)
    assert model.step_kind == "fused" and model.number_of_dofs() == jm.number_of_dofs()
    model.rk(0.0, 5 * dt)
    jm.rk(0.0, 5 * jdt)
    ref = np.asarray(jm.u_n)
    assert np.max(np.abs(ref)) > 0
    _close(model.u_n.reshape(-1).numpy(), ref, 1e-10)


def test_ph1_sc2_bowl_model_matches_jax():
    """PH1 SC2 on the bowl-fitted mesh (``drivers/ph1.py::build_model(...,
    bowl=True)``: the Westervelt model at β = 0 on the hybrid path, dt
    clamped by the measured spectrum) against the JAX ``build_model``: dt, steps per
    period and 5 RK4 steps (1e-10); SC1 refuses the bowl."""
    from fenicsxfus_tpu_torch.drivers import ph1

    jph1 = _load("ph1_common", os.path.join(ROOT, "benchmarks", "ph1", "common.py"))
    model, _, h, dt, spp = ph1.build_model(2, 4, 8, dtype=torch.float64, bowl=True,
                                           device="cpu")
    jm, _, jh, jdt, jspp = jph1.build_model(2, 4, 8, dtype=jnp.float64, bowl=True)
    assert (h, dt, spp) == (jh, jdt, jspp) and model.ops.hybrid is not None
    model.rk(0.0, 5 * dt)
    jm.rk(0.0, 5 * jdt)
    ref = np.asarray(jm.u_n)
    assert np.max(np.abs(ref)) > 0
    _close(model.u_n.reshape(-1).numpy(), ref, 1e-10)
    with pytest.raises(ValueError, match="SC2"):
        ph1.build_model(1, 1, 8, bowl=True, device="cpu")


def test_full_run_matches_jax(tmp_path):
    """``run(full=True)`` (1.1 MHz) at a small size against the JAX driver,
    and its artifact's keys and harmonics-ready arrays."""
    kw = dict(nx=6, degree=2, full=True, final_time=6e-6)
    out = str(tmp_path / "full.npz")
    jout = str(tmp_path / "full_jax.npz")
    x_ref, amp_ref = jax_hitu.run("W", "H131", "WATER", dtype=jnp.float64, out=jout, **kw)
    res = hitu.run("W", "H131", "WATER", dtype=torch.float64, device="cpu", out=out, **kw)
    assert res.model.freq == 1.1e6
    np.testing.assert_array_equal(res.x, x_ref)
    _close(res.amplitude, amp_ref, 1e-10)
    a, b = np.load(out), np.load(jout)
    assert sorted(a.files) == sorted(b.files)
    for k in ("x", "sensor_x", "times"):
        np.testing.assert_array_equal(a[k], b[k])
    _close(a["waveforms"], b["waveforms"], 1e-10)
    ma, mb = json.loads(str(a["meta"])), json.loads(str(b["meta"]))
    for k in ("variant", "f0", "nx", "degree", "dt", "ndofs", "tf"):
        assert ma[k] == mb[k], k


def test_h131_oneil_check_matches_jax():
    """The H131 O'Neil check at 0.45 MHz (the committed
    ``oneil_h131_0.45mhz.npz``'s frequency) at a small size: the same
    three errors as the JAX driver's."""
    kw = dict(f0=0.45e6, nx=8, degree=2)
    got = hitu.validate_oneil("H131", dtype=torch.float64, device="cpu", **kw)
    ref = jax_hitu.validate_oneil("H131", dtype=jnp.float64, **kw)
    for a, b in zip(got, ref):
        assert abs(a - b) <= 1e-10 * abs(b) + 1e-15


def test_check_artifact(tmp_path):
    """Against its own committed run a run passes with no difference; a
    peak 3% high or a peak moved by two sensors misses; other sensors
    raise."""
    npz = os.path.join(RESULTS, "w_h131_water_full11MHz.npz")
    d = np.load(npz)
    run = hitu.HituRun(d["x"], d["amplitude"].astype(np.float64), None, 0.0, 0.0, 0)
    chk = hitu.check_artifact(run, npz)
    assert chk["ok"] and chk["rel_peak"] == 0.0 and chk["profile_rel"] == 0.0
    assert chk["sensor"] == chk["ref_sensor"] == 61
    high = hitu.HituRun(run.x, run.amplitude * 1.03, None, 0.0, 0.0, 0)
    assert not hitu.check_artifact(high, npz)["ok"]
    moved = hitu.HituRun(run.x, np.roll(run.amplitude, 2), None, 0.0, 0.0, 0)
    assert not hitu.check_artifact(moved, npz)["ok"]
    near = hitu.HituRun(run.x, np.roll(run.amplitude, 1) * 1.01, None, 0.0, 0.0, 0)
    assert hitu.check_artifact(near, npz)["ok"]
    other = hitu.HituRun(run.x[::2], run.amplitude[::2], None, 0.0, 0.0, 0)
    with pytest.raises(ValueError, match="sensors"):
        hitu.check_artifact(other, npz)


def test_cli_check(tmp_path):
    """``--out`` then ``--check`` of the same file passes; a committed run
    of another problem ends the command with an error."""
    out = str(tmp_path / "r.npz")
    argv = ["W", "H131", "WATER", "--nx", "6", "--degree", "2", "--f0", "1e5", "--device", "cpu"]
    hitu.main(argv + ["--out", out])
    hitu.main(argv + ["--check", out])
    with pytest.raises(SystemExit, match="focal peak"):
        hitu.main(argv + ["--check", os.path.join(RESULTS, "w_h131_water.npz")])


ARTIFACTS = ["w_h131_water_full11MHz.npz", "w_h131_water_p5_full11MHz.npz",
             "w_h101_water.npz", "w_h131_liver.npz", "v_h131_water.npz"]


@pytest.mark.parametrize("name", ARTIFACTS)
def test_harmonics_match_jax(name):
    sys.path.insert(0, HITU_DIR)
    try:
        import harmonics as jharm

        ref = jharm.analyze(os.path.join(RESULTS, name))
        d = np.load(os.path.join(RESULTS, name))
        f0 = json.loads(str(d["meta"]))["f0"]
        ns = d["waveforms"].shape[1]
        for j in (0, ns // 2, ns - 1):
            _close(harmonics.harmonic_amplitudes(d["times"], d["waveforms"][:, j], f0),
                   jharm.harmonic_amplitudes(d["times"], d["waveforms"][:, j], f0), 1e-12)
    finally:
        sys.path.remove(HITU_DIR)
    got = harmonics.analyze(os.path.join(RESULTS, name))
    assert len(got["rows"]) == len(ref["rows"]) == len(np.load(os.path.join(RESULTS, name))[
        "sensor_x"])
    for a, b in zip(got["rows"], ref["rows"]):
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-12 * max(abs(b[k]), 1e-300), (k, a[k], b[k])
    assert (got["gate"] is None) == (ref["gate"] is None)
    if ref["gate"] is not None:
        assert got["gate"]["pass"] == ref["gate"]["pass"]
        assert got["gate"]["stations"] == ref["gate"]["stations"]
        for k in ("median_rel", "worst_rel", "median_rel_3rd"):
            assert got["gate"][k] == pytest.approx(ref["gate"][k], rel=1e-12)


def test_harmonics_cli(tmp_path):
    """The committed p = 5 run passes the gate (exit 0) and writes the
    JSON; the p = 4 run's gate fails (exit 1), as in the JAX tool."""
    js = str(tmp_path / "h.json")
    assert harmonics.main([os.path.join(RESULTS, "w_h131_water_p5_full11MHz.npz"),
                           "--json", js]) == 0
    assert json.load(open(js))["gate"]["pass"]
    ok = harmonics.analyze(os.path.join(RESULTS, "w_h131_water_full11MHz.npz"))["gate"]["pass"]
    assert harmonics.main([os.path.join(RESULTS, "w_h131_water_full11MHz.npz")]) == (
        0 if ok else 1)


@pytest.mark.parametrize("kind", ["linear", "westervelt"])
def test_drift_build_matches_jax(kind):
    """The drift problem's fp64 model: the same dt and 250 steps to 1e-10
    of ``benchmarks/fp32_drift.py``'s build."""
    model, dt = fp32_drift.build(kind, torch.float64, "cpu")
    jm, jdt = jax_drift.build(kind, jnp.float64)
    assert dt == jdt and model.number_of_dofs() == jm.number_of_dofs()
    model.rk(0.0, 250 * dt)
    jm.rk(0.0, 250 * jdt)
    _close(model.u_n.reshape(-1).numpy(), np.asarray(jm.u_n), 1e-10)


@pytest.mark.parametrize("table", ["fp32_drift.txt", "fp32_drift_westervelt.txt"])
def test_drift_table_and_gates(table):
    """``table`` writes the committed tables' data lines exactly, and
    ``gates`` passes them and flags a drift above 1e-4 past 7488 steps, a
    short table and (linear) an fp32 error above twice fp64's."""
    kind = "westervelt" if "westervelt" in table else "linear"
    path = os.path.join(ROOT, "benchmarks", table)
    rows = [tuple(r) for r in np.loadtxt(path)]
    rows = [(int(r[0]),) + r[1:] for r in rows]
    text = fp32_drift.table(rows, 8000, kind, "CPU")
    data = [ln for ln in open(path).read().splitlines() if not ln.startswith("#")]
    assert [ln for ln in text.splitlines() if not ln.startswith("#")] == data
    assert text.splitlines()[2] == open(path).read().splitlines()[2]
    assert fp32_drift.gates(rows, kind) == []
    bad = [r if r[0] < 7488 else (r[0], 2e-4) + r[2:] for r in rows]
    assert fp32_drift.gates(bad, kind)
    assert fp32_drift.gates([r for r in rows if r[0] < 7488], kind)
    if kind == "linear":
        worse = [r[:4] + (3 * r[3],) if np.isfinite(r[3]) else r for r in rows]
        assert fp32_drift.gates(worse, kind)


def test_drift_short_run_on_the_cpu():
    """``drift`` marches both dtypes to each checkpoint: fp32 drifts from
    fp64 by more than fp64 rounding and far less than the gate."""
    rows, m64, m32 = fp32_drift.drift(250, "linear", "cpu")
    assert [r[0] for r in rows] == [250]
    assert m32.u_n.dtype == torch.float32 and m64.u_n.dtype == torch.float64
    assert 1e-9 < rows[0][1] < 1e-5
