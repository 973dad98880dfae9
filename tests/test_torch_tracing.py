"""The port's spans (``fenicsxfus_tpu_torch/analysis/timing.py``) on the CPU:
off by default (nothing recorded, no profiler range opened), nesting and
self times when on, ``tracing()`` scopes, the names in a ``torch.profiler``
Chrome trace, ``FUS_TRACE=1`` read at import, and the spans that the
drivers' set-up entries and ``rk_record`` open, at tiny sizes.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fenicsxfus_tpu_torch.analysis import timing
from fenicsxfus_tpu_torch.analysis.timing import span, traced, tracing
from fenicsxfus_tpu_torch.drivers import hitu, ph1

REPO = Path(__file__).resolve().parents[1]
SETUP_COMMON = {"fus.setup", "fus.setup.mesh", "fus.setup.operators", "fus.setup.assembly",
                "fus.setup.source", "fus.setup.upload"}
LOOP = ("fus.rk_record", "fus.loop.step_build", "fus.loop.sensor_plan", "fus.loop.march")


@pytest.fixture(autouse=True)
def fresh_registry():
    timing.reset_timings()
    yield
    timing.reset_timings()


def _annotations(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    return [e["name"] for e in events
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith("fus.")]


@traced("fus.test.decorated")
def _decorated(x):
    return x + 1


def test_off_records_nothing_and_returns_the_shared_noop():
    with tracing(False):
        a, b = span("fus.test.a"), span("fus.test.b", sync=True)
        assert a is b is timing._OFF
        with a:
            with span("fus.test.inner"):
                pass
        assert _decorated(1) == 2
    assert timing.snapshot() == {}
    assert "span" not in timing.list_timings()


def test_nesting_self_times_and_parents():
    with tracing():
        with span("fus.test.outer"):
            time.sleep(0.002)
            for _ in range(3):
                with span("fus.test.a"):
                    time.sleep(0.001)
            with span("fus.test.b", sync=torch.device("cpu")):
                with span("fus.test.a"):
                    pass
        assert _decorated(2) == 3
    s = timing.snapshot()
    assert set(s) == {"fus.test.outer", "fus.test.a", "fus.test.b", "fus.test.decorated"}
    assert [s[n]["calls"] for n in ("fus.test.outer", "fus.test.a", "fus.test.b")] == [1, 4, 1]
    assert s["fus.test.outer"]["parent"] is None and s["fus.test.decorated"]["parent"] is None
    assert s["fus.test.a"]["parent"] == "fus.test.outer"  # the first call's parent
    assert s["fus.test.b"]["parent"] == "fus.test.outer"
    outer = s["fus.test.outer"]
    # the outer span's children are three calls of a and one of b (whose own
    # child a is b's, not outer's)
    a_direct = s["fus.test.a"]["total_s"] - (s["fus.test.b"]["total_s"] - s["fus.test.b"]["self_s"])
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - a_direct - s["fus.test.b"]["total_s"], abs=1e-9)
    assert outer["self_s"] >= 0.002 and s["fus.test.a"]["total_s"] >= 0.003
    for v in s.values():
        assert 0.0 <= v["self_s"] <= v["total_s"]
    assert "fus.test.outer" in timing.list_timings(clear=True)
    assert "fus.test.outer" not in timing.list_timings() and timing.snapshot() == {}


def test_tracing_scopes_restore_the_switch():
    assert timing._on is False
    with tracing():
        assert timing._on is True
        with tracing(False):
            assert span("fus.test.x") is timing._OFF
        assert isinstance(span("fus.test.x"), timing._Span)
        with pytest.raises(RuntimeError):
            with tracing(False):
                raise RuntimeError("boom")
        assert timing._on is True
    assert timing._on is False


def test_a_span_closes_on_an_exception():
    with tracing():
        with pytest.raises(ValueError):
            with span("fus.test.outer"):
                with span("fus.test.raises"):
                    raise ValueError("x")
        with span("fus.test.after"):
            pass
    s = timing.snapshot()
    assert s["fus.test.raises"]["calls"] == 1 and s["fus.test.after"]["parent"] is None


def test_spans_are_user_annotations_in_the_profiler_trace(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing():
            with span("fus.test.outer"):
                with span("fus.test.inner"):
                    torch.ones(8).sum()
                _decorated(1)
        with span("fus.test.off"):
            torch.ones(8).sum()
    names = _annotations(prof, tmp_path)
    assert sorted(names) == ["fus.test.decorated", "fus.test.inner", "fus.test.outer"]


def test_fus_trace_is_read_at_import():
    code = ("from fenicsxfus_tpu_torch.analysis import timing; "
            "import fenicsxfus_tpu_torch; "
            "s = timing.snapshot(); "
            "assert timing._on and s['fus.import']['calls'] == 1, s")
    env = {**os.environ, "FUS_TRACE": "1"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


BUILDS = {
    "hitu-flat": (lambda: hitu.build_model("W", "H101", "WATER", 6, degree=2, f0=1e5,
                                           dtype=torch.float64, device="cpu")[0],
                  SETUP_COMMON),
    "hitu-bowl": (lambda: hitu.build_bowl_model("W", "H101", "WATER", 10, degree=2, f0=1e5,
                                                dtype=torch.float64, device="cpu")[0],
                  SETUP_COMMON | {"fus.setup.stable_dt", "fus.band", "fus.band.gather",
                                  "fus.band.cells", "fus.band.scatter"}),
    "ph1-bm6": (lambda: ph1.build_model(2, 6, 8, dtype=torch.float64, device="cpu")[0],
                SETUP_COMMON),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_setup_entries_record_their_spans(name):
    build, expected = BUILDS[name]
    with tracing():
        build()
    s = timing.snapshot()
    # on the CPU there is no context to make, and the native library loads
    # only for large meshes
    assert expected <= set(s) <= expected | {"fus.setup.library"}, sorted(s)
    assert s["fus.setup"]["calls"] == 1 and s["fus.setup"]["parent"] is None
    for n in ("fus.setup.mesh", "fus.setup.assembly"):
        assert s[n]["parent"] == "fus.setup"
    assert s["fus.setup.operators"]["parent"] == "fus.setup.assembly"
    inside = [v["self_s"] for n, v in s.items() if n.startswith("fus.setup.")
              or n.startswith("fus.band")]
    assert sum(inside) <= s["fus.setup"]["total_s"]
    assert s["fus.setup"]["self_s"] >= 0.0


def test_rk_record_opens_its_four_spans_once_a_call():
    model, _, dt, _ = hitu.build_model("W", "H101", "WATER", 6, degree=2, f0=1e5,
                                       dtype=torch.float64, device="cpu")
    pts = hitu.axial_points("H101", 5)
    with tracing():
        for k in range(2):
            model.rk_record(k * 3 * dt, (k + 1) * 3 * dt, pts)
    s = timing.snapshot()
    assert set(s) == set(LOOP)
    assert [s[n]["calls"] for n in LOOP] == [2, 2, 2, 2]
    assert s["fus.rk_record"]["parent"] is None
    assert all(s[n]["parent"] == "fus.rk_record" for n in LOOP[1:])


def test_off_really_is_off(tmp_path):
    """Tracing off (no ``FUS_TRACE``): a model build and a whole
    ``rk_record``, on the bowl with its K6 calls, leave the registry empty
    and open no profiler range."""
    assert timing._on is False
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model, _, dt, _ = hitu.build_bowl_model("W", "H101", "WATER", 8, degree=2, f0=1e5,
                                                dtype=torch.float64, device="cpu")
        model.rk_record(0.0, 2 * dt, hitu.axial_points("H101", 5))
    assert timing.snapshot() == {}
    assert _annotations(prof, tmp_path) == []
    assert np.isfinite(model.u_n.numpy()).all()
