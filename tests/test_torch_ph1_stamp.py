"""The port's PH1 validation stamp (``fenicsxfus_tpu_torch/drivers/ph1.py``:
``published_values``, ``published_comparison``, ``focal_comparison``,
``validate`` and ``--validate``) against the JAX package's
``benchmarks/ph1/validate.py``: the published-table loader on temporary
files (the port of ``test_published_values_loader_schema``), the focal
deltas of the committed water runs (1e-12), and the whole stamp with the
same profile runner in both (1e-10 on every number), written only where
``out`` says.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmarks.ph1 import validate as jval
from fenicsxfus_tpu_torch.drivers import ph1

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "benchmarks", "ph1", "results")
ENTRY = {"source": "doi:10.1121/10.0013426, Table III", "code": "KWAVE",
         "focal_p_Pa": 1.0e6, "focal_x_m": 0.0635, "ext6_m": 0.020}


def _same(got, ref, tol=1e-10, path="stamp"):
    """Every key equal, every number within ``tol`` (relative)."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), (path, sorted(got), sorted(ref))
        for k in ref:
            _same(got[k], ref[k], tol, f"{path}.{k}")
    elif isinstance(ref, (bool, str)) or ref is None:
        assert got == ref, (path, got, ref)
    else:
        assert abs(got - ref) <= tol * max(abs(ref), 1e-300), (path, got, ref)


def test_published_values_loader_schema(tmp_path, monkeypatch):
    """A missing file or case gives None; an entry without its provenance
    fields is refused; a complete entry gives the JAX package's deltas. No
    table is in the repository: the default path does not exist."""
    assert not os.path.exists(ph1.PUBLISHED_FILE)
    assert ph1.published_values(1, 1) is None
    assert ph1.published_values(1, 1, str(tmp_path / "none.json")) is None
    path = tmp_path / "published.json"
    path.write_text(json.dumps({"SC1-BM1": {"code": "KWAVE", "focal_p_Pa": 1.0e6}}))
    with pytest.raises(ValueError, match="provenance"):
        ph1.published_values(1, 1, str(path))
    assert ph1.published_values(1, 2, str(path)) is None
    path.write_text(json.dumps({"SC1-BM1": ENTRY}))
    x = np.linspace(0.0, 0.12, 2001)
    amp = 1.0e6 * np.exp(-((x - 0.0635) / 0.009) ** 2)
    rec = ph1.published_comparison(1, 1, x, amp, str(path))
    assert rec["dp_rel"] < 1e-3 and rec["dx_mm"] < 0.1
    monkeypatch.setattr(jval, "PUBLISHED_FILE", str(path))
    _same(rec, jval.published_comparison(1, 1, x, amp), 1e-12)
    assert ph1.published_comparison(1, 3, x, amp, str(path)) is None


@pytest.mark.parametrize("sc, bm", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_focal_comparison_matches_jax(sc, bm):
    """The committed water runs' focal deltas equal the JAX function's
    (1e-12), within the JAX suite's gates (``tests/test_ph1_validation.py``)."""
    d = np.load(os.path.join(RESULTS, f"sc{sc}_bm{bm}.npz"))
    x, amp = d["x"].astype(np.float64), d["amplitude"].astype(np.float64)
    got = ph1.focal_comparison(sc, bm, x, amp)
    _same(got, jval.focal_comparison(sc, bm, x, amp), 1e-12)
    gates = {(1, 1): (0.05, 2.0, 0.15), (1, 2): (0.12, 1.5, 0.10),
             (2, 1): (0.10, 1.5, 0.05), (2, 2): (0.15, 1.5, 0.05)}[(sc, bm)]
    assert all(v < g for v, g in zip((got["dp_rel"], got["dx_mm"], got["dext_rel"]), gates))
    assert ph1.focal_comparison(1, 4, x, amp) is None


def _profile(sc, bm, nx, tf=None):
    """A synthetic axial profile of (sc, bm, nx, tf): the closed form with a
    ripple that depends on every argument (the runner both stamps share)."""
    tf = tf or ph1.default_final_time()
    x = ph1.axial_points()[0]
    amp = ph1._complex_axial_amplitude(x, sc, 0.0) * (
        1.0 + 0.02 * np.sin(40.0 * x * nx + bm) + 1e3 * (tf - ph1.default_final_time()))
    return x, amp


@pytest.mark.parametrize("sc, bm", [(1, 1), (1, 4), (2, 6)])
def test_validate_matches_jax(sc, bm, tmp_path, monkeypatch):
    """``validate`` against the JAX ``validate`` with the same profile
    runner in both: the stamps are equal on every number (1e-10), each
    profile runs once, and the port's stamp is written only to ``out``."""
    calls = []

    def port_runner(sc, bm, nx, tf=None, dtype=None, device="cuda", profiles=None):
        key = (sc, bm, nx, tf or ph1.default_final_time())
        if key in profiles:
            return profiles[key]
        calls.append(key)
        profiles[key] = _profile(sc, bm, nx, key[3])
        return profiles[key]

    monkeypatch.setattr(ph1, "run_profile", port_runner)
    monkeypatch.setattr(jval, "_run_profile",
                        lambda sc, bm, nx, tf=None, dtype=None: _profile(sc, bm, nx, tf) + (
                            None, None, 0))
    table = tmp_path / "published.json"
    table.write_text(json.dumps({f"SC{sc}-BM{bm}": ENTRY}))
    monkeypatch.setattr(jval, "PUBLISHED_FILE", str(table))
    before = sorted(os.listdir(RESULTS))
    out = tmp_path / "stamp" / "port.json"
    got = ph1.validate(sc, bm, 16, 24, dtype=torch.float64, out=str(out), device="cpu",
                       published=str(table))
    ref = jval.validate(sc, bm, 16, 24, out=str(tmp_path / "jax.json"))
    assert got["platform"] == "cpu" == ref["platform"]
    _same(got, ref)
    _same(json.loads(out.read_text()), ref)
    assert sorted(os.listdir(RESULTS)) == before
    assert len(calls) == len(set(calls)) == (4 if bm == 4 else 3)
    assert ("published" in got) and (("focal" in got) == (bm in (1, 2)))
    assert ("transmission_1d" in got) == (bm == 4)


def test_validate_cli(tmp_path, monkeypatch):
    """``--validate`` runs ``validate`` on the case and writes the stamp to
    ``--out``."""
    seen = {}
    monkeypatch.setattr(ph1, "validate", lambda *a, **k: seen.update(args=a, kw=k))
    ph1.main(["--validate", "--sc", "1", "--bm", "4", "--nx", "20", "--nx-fine", "28",
              "--out", str(tmp_path / "s.json"), "--device", "cpu", "--dtype", "float64"])
    assert seen["args"] == (1, 4, 20, 28)
    assert seen["kw"]["out"] == str(tmp_path / "s.json") and seen["kw"]["device"] == "cpu"
    assert seen["kw"]["dtype"] == torch.float64 and seen["kw"]["published"] is None
    with pytest.raises(SystemExit):
        ph1.main(["--validate", "--all"])
