"""The port's bowl and PH1 scripts (``fenicsxfus_tpu_torch/tools/
{bowl_blend_sweep,bowl_spectrum}.py``, ``drivers/{ph1_sc1_bm1,
bowl_convergence}.py``) against the JAX package's scripts at tiny sizes on
the CPU: the sweep's rows (geometry exact, the dt ratio within 1e-4 in
fp32), the per-cell power iteration (1e-10), the SC1-BM1 axial pressure
(1e-10) and the bowl mesh's O'Neil errors (fp64) equal the JAX scripts'.
The card's runs are ``chip_smoke.py`` [19].
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu
import fenicsxfus_tpu.core.bowl as jbowl
from fenicsxfus_tpu.core.gll import diff_matrix
from fenicsxfus_tpu_torch.core.bowl import create_bowl_box
from fenicsxfus_tpu_torch.core.geometry import volume_factors
from fenicsxfus_tpu_torch.drivers import bowl_convergence, hitu, ph1_sc1_bm1
from fenicsxfus_tpu_torch.tools import bowl_blend_sweep, bowl_spectrum

torch.set_num_threads(1)


def test_bowl_blend_sweep_matches_jax(monkeypatch):
    """All twelve (blend, hold) points at nx = 6: the JAX script's meshes,
    slab cells and ``estimate_stable_dt`` (recorded as it runs) against the
    port's rows."""
    meshes, dts = [], []
    make = jbowl.create_bowl_box

    def record_mesh(*a, **k):
        out = make(*a, **k)
        meshes.append(out[0])
        return out

    est = fenicsxfus_tpu.estimate_stable_dt

    def record_dt(ops, *a, **k):
        dt = est(ops, *a, **k)
        dts.append((ops.hybrid["nb"] if ops.hybrid else 0, dt))
        return dt

    monkeypatch.setattr(jbowl, "create_bowl_box", record_mesh)
    monkeypatch.setattr(fenicsxfus_tpu, "estimate_stable_dt", record_dt)
    nx = 6
    importlib.import_module("benchmarks.bowl_blend_sweep").main(nx)
    res = bowl_blend_sweep.main(nx=nx, device="cpu")
    rows = res["rows"]
    assert len(rows) == 12 == len(meshes) == len(dts)
    h = 0.12 / nx
    dtu = h / (1480.0 * 16)
    for r, mesh, (nb, dt) in zip(rows, meshes, dts):
        assert "failed" not in r
        assert r["frac"] == nb / mesh.num_cells and r["layers"] == mesh.blend_layers
        assert r["hmin_h"] == mesh.h_min() / h
        assert abs(r["ratio"] - dt / dtu) <= 1e-4 * (dt / dtu)
    best = min(rows, key=lambda r: r["proxy"])
    assert res["best"] is best and [r["mb"] for r in rows[::3]] == [2.0, 3.0, 4.0, 5.0]


def test_bowl_blend_sweep_keeps_refused_points(monkeypatch):
    """A point whose mesh ``create_bowl_box`` refuses is a row of its own;
    any other failure raises."""
    def refuse(*a, **k):
        raise ValueError("no mesh")

    monkeypatch.setattr(bowl_blend_sweep, "create_bowl_box", refuse)
    res = bowl_blend_sweep.main(nx=8, blends="2", holds="0.25", device="cpu")
    assert res["rows"] == [{"mb": 2.0, "mh": 0.25, "failed": "ValueError: no mesh"}]
    assert res["best"] is None

    def fail(*a, **k):
        raise RuntimeError("broken")

    monkeypatch.setattr(bowl_blend_sweep, "create_bowl_box", fail)
    with pytest.raises(RuntimeError):
        bowl_blend_sweep.main(nx=8, blends="2", holds="0.25", device="cpu")


@pytest.mark.parametrize("global_mass", [False, True])
def test_percell_lambda_matches_jax(global_mass):
    """The band cells of the H101 bowl mesh at nx = 10, the same numpy
    seed: λ equal to the JAX script's ``percell_lambda`` (1e-10)."""
    jspec = importlib.import_module("benchmarks.bowl_spectrum")
    g = hitu.TRANSDUCERS["H101"]
    mesh, _ = create_bowl_box((10, 6, 6), (0, -0.035, -0.035), (0.12, 0.035, 0.035), g["roc"],
                              g["a"], blend=0.0174, lateral_hold=0.00435)
    nb = mesh.blend_layers * 36
    sub = type(mesh)(dim=3, vertices=mesh.vertices, cells=mesh.cells[:nb])
    wdetJ, G = volume_factors(sub, 5)
    mass = None
    if global_mass:
        mass = wdetJ * (1.0 + np.random.default_rng(2).random(wdetJ.shape))
    G = G.reshape((nb,) + (5,) * 3 + (6,))  # as the JAX script passes it
    lam = bowl_spectrum.percell_lambda(G, wdetJ, diff_matrix(5), mass=mass, device="cpu")
    jlam = jspec.percell_lambda(G, wdetJ, diff_matrix(5), mass=mass)
    assert lam.shape == (nb,) and np.max(np.abs(lam - jlam)) <= 1e-10 * np.max(jlam)


def test_bowl_spectrum_main():
    res = bowl_spectrum.main(nx=10, device="cpu")
    s = res["summary"]
    assert res["band_cells"] == res["blend_layers"] * 36 and len(res["layers"]) == 3
    assert s["max"] >= s["p99"] >= s["median"] > 0 and s["clamp"] == np.sqrt(s["max"])


def test_ph1_sc1_bm1_matches_jax(monkeypatch):
    """nx = 4 over half a crossing at the JAX script's cfl 0.9, fp64: the
    axial pressure equals the JAX script's (recorded from its
    ``eval_function``) within 1e-10."""
    vals = []
    ev = fenicsxfus_tpu.eval_function
    monkeypatch.setattr(fenicsxfus_tpu, "eval_function",
                        lambda *a: vals.append(ev(*a)[1]) or ev(*a))
    importlib.import_module("benchmarks.ph1_sc1_bm1").main(nx=4, periods=0.5)
    res = ph1_sc1_bm1.main(nx=4, periods=0.5, cfl=0.9, device="cpu")
    assert res["eqn"].step_kind == "unfused" and res["nsteps"] == 36
    assert res["values"].shape == (24,) and np.max(np.abs(res["values"])) > 100
    assert np.max(np.abs(res["values"] - vals[0])) <= 1e-10 * np.max(np.abs(vals[0]))


def test_bowl_convergence_matches_jax():
    """At 200 kHz on nx = 3 (nx = 1 builds too, but its blend slab is the
    whole mesh; at 3 it is one layer of three), fp64: the O'Neil errors
    equal the JAX package's ``validate_bowl_mesh`` (1e-10)."""
    common = importlib.import_module("benchmarks.hitu.common")
    jerr = common.validate_bowl_mesh("H101", f0=200e3, nx=3, dtype=jnp.float64)
    res = bowl_convergence.main(nx="3", device="cpu")
    (row,) = res["rows"]
    assert row["held"] is None and res["dtype"] == "torch.float64"
    got = (row["gain_err"], row["pos_err"], row["profile_err"])
    assert np.allclose(got, jerr, rtol=1e-10, atol=0)


def test_bowl_convergence_reference_file():
    """The JAX package's committed values: nx = 20, 28, 36 at 200 kHz, with
    the commit and the command that made them."""
    data = json.loads(bowl_convergence.REFERENCE.read_text())
    ref = bowl_convergence.reference()
    assert sorted(ref) == [20, 28, 36] and data["f0"] == 200e3 and data["dtype"] == "float64"
    assert len(data["jax_commit"]) == 40 and "validate_bowl_mesh" in data["command"]
    for r in ref.values():
        assert 0 < r["gain_err"] < 1 and 0 <= r["pos_err"] < 0.12 and 0 < r["profile_err"] < 1

