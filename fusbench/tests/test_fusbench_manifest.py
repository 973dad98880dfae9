"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name."""

import json
import re

import pytest

from fusbench import cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MANIFEST = cell.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_limits():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(not w.startswith("/") for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 a cell, 1200
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_units_and_sources():
    m = MANIFEST
    names = [c["name"] for c in m["configs"]] + CELLS
    metrics = m["end_to_end"] + m["per_layer"]
    names += [x["name"] for x in metrics]
    assert all(NAME.match(n) for n in names), names
    assert len({c["name"] for c in m["configs"]}) == len(m["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len({x["name"] for x in metrics}) == len(metrics)
    for x in metrics:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in SOURCES
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["moves"] in {e["name"] for e in m["end_to_end"]}
        assert "\n" not in x["layer"] and 1 <= len(x["layer"]) <= 200
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    for name in CELLS:
        c = cell.resolve(name)
        e2e = {x["name"] for x in c["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c["per_layer"]
        for x in c["per_layer"]:
            assert x["moves"] in e2e


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = cell.resolve(name)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["traffic"]["name"] == c["workload"]["traffic"]
    conf = next(x for x in MANIFEST["configs"] if x["name"] == c["config"]["name"])
    assert conf["reduced"] == c["config"]["reduced"]
    assert {"trace_err", "state_err"} <= set(c["traffic"]["limits"])
    for m in c["per_layer"]:
        assert callable(cell.metric_reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cell.resolve("no-such-cell")
