"""The import guard, the bound arithmetic and the trace reading; and, on a
card, one short run of the command."""

import json
import subprocess
import sys
import types

import pytest

from fusbench import bounds, run, trace
from fusbench.tests.conftest import ROOT


def test_guard_compares_top_level_names_whole(monkeypatch):
    for name in ("fenicsxfus_tpu_torch", "fenicsxfus_tpu_torch.ops", "fenicsxfus_tpuX",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == [] or set(run.forbidden_modules()) <= {"jax"}
    monkeypatch.setitem(sys.modules, "fenicsxfus_tpu.core", types.ModuleType("x"))
    assert "fenicsxfus_tpu" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert "jaxlib" in run.forbidden_modules()


def test_step_floor_from_shapes():
    g = (321, 189, 189)
    f = bounds.step_floor(g, 4)
    nodes = 321 * 189 * 189
    assert f["bytes"] == 4 * 4 * nodes
    assert f["bound_by"] == "bytes"
    assert abs(f["bound_ms"] - 16 * nodes / 3.35e12 * 1e3) < 1e-12
    slab = bounds.step_floor(g, 4, slab_cells=16 * 47 * 47)
    assert slab["flops"] == f["flops"] + 4 * 16 * 47 * 47 * 125 * 75


def test_trace_parse_attributes_spans_and_gaps():
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "fusbench.band", "ts": 10, "dur": 20,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 12, "dur": 1, "tid": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 40, "dur": 1, "tid": 1,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k6", "ts": 50, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 65, "dur": 10,
         "args": {"correlation": 8}},
    ]
    tr = trace.parse(ev, ("fusbench.band",))
    assert [o["spans"] for o in tr["ops"]] == [["fusbench.band"], []]
    assert abs(tr["busy_s"] - 15e-6) < 1e-12
    assert [g[0] for g in tr["gaps"]] == ["outer"] and abs(tr["gaps"][0][1] - 10e-6) < 1e-12
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] == "k2"


@pytest.mark.gpu
def test_command_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "fusbench.run", "--workload", "h101-flat",
                          "--seed", "3000000001", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_result_line_is_strict_json():
    out = run.finite({"checks": {"trace_err": {"value": float("inf"), "limit": 1e-4}},
                      "info": [float("nan"), 1.0]})
    assert json.loads(json.dumps(out, allow_nan=False)) == {
        "checks": {"trace_err": {"value": None, "limit": 1e-4}}, "info": [None, 1.0]}
