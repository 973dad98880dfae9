"""The readers of the port's spans, ``idle_by_program_span`` and the parse
that adds the port's spans to a traced run's trace (``fusbench/spans.py``),
on synthetic traces and contexts: what the existing readers and
``breakdown`` read does not change when the trace holds the port's spans."""

import pytest

from fusbench import cell, run, spans, trace

US = 1e-6


def _x(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if args:
        e["args"] = args
    return e


# the benchmark's own events of two periods: host operations, launches
# (one of them inside the benchmark's band span) and device operations
BASE = [
    _x("user_annotation", "fusbench._record_plan", 150, 240),
    _x("cpu_op", "aten::index_select", 160, 20),
    _x("cuda_runtime", "launch", 280, 2, correlation=1),
    _x("user_annotation", "fusbench.band", 505, 90),
    _x("cuda_runtime", "launch", 510, 2, correlation=2),
    _x("cuda_runtime", "launch", 560, 2, correlation=3),
    _x("kernel", "k2", 300, 150, correlation=1),
    _x("kernel", "k6", 600, 100, correlation=2),
    _x("gpu_memcpy", "copy", 700, 200, correlation=3),
    _x("kernel", "early", 0, 50),  # before the first traced rk_record
]
# the port's spans of the same periods, and one on another thread
PROGRAM = [
    _x("user_annotation", "fus.rk_record", 100, 900),
    _x("user_annotation", "fus.loop.step_build", 100, 50),
    _x("user_annotation", "fus.loop.sensor_plan", 150, 250),
    _x("user_annotation", "fus.loop.march", 400, 600),
    _x("user_annotation", "fus.band", 500, 100),
    _x("user_annotation", "fus.band.cells", 520, 60),
    _x("user_annotation", "fus.rk_record", 1100, 100),
    _x("user_annotation", "fus.loop.step_build", 1100, 20),
    _x("user_annotation", "fus.loop.sensor_plan", 1120, 80),
    _x("user_annotation", "fus.setup.upload", 0, 5000, tid=2),
]


def test_idle_by_program_span_head_tail_and_a_gap_over_two_spans():
    """Idle [100, 300) is the head (step build, sensor plan); [450, 600) lies
    across the march, the band and its cells; [900, 1200) is the tail: the
    march, no span, then the second call's plan."""
    got = spans.idle_by_program_span(BASE + PROGRAM)
    want = {"fus.loop.sensor_plan": 230, "fus.loop.march": 150, "fus.loop.step_build": 70,
            "none": 100, "fus.band.cells": 60, "fus.band": 40}
    assert set(got) == set(want)
    for name, us in want.items():
        assert got[name] == pytest.approx(us * US, abs=1e-12), name
    assert sum(got.values()) == pytest.approx(650 * US)
    assert spans.idle_by_program_span(BASE) == {}


def test_innermost_cuts_a_child_at_its_parent_end():
    segs = spans._innermost([(0, 10, "a"), (2, 4, "b"), (8, 12, "c"), (20, 30, "d")])
    assert segs == [(0, 2, "a"), (2, 4, "b"), (4, 8, "a"), (8, 10, "c"), (20, 30, "d")]


def _ctx(tr, with_spans=False):
    tr = dict(tr, window_s=1200 * US)
    ctx = {"setup": {"model_s": 9.5, "import_s": 10.2}, "trace": tr, "steps": 4,
           "floor_ms": 0.0001, "band_span": run.BAND_SPAN}
    if with_spans:
        ctx["spans"] = {"fus.rk_record": {"calls": 3, "total_s": 9.0, "self_s": 0.1,
                                          "parent": None}}
    return ctx


EXISTING = [m["name"] for m in cell.load_manifest()["per_layer"]
            if m["name"] != "band.launches_per_step"]


@pytest.mark.parametrize("name", EXISTING)
def test_existing_readers_read_the_same_with_the_port_spans(name):
    names = (run.BAND_SPAN, *run.PLAN_SPANS)
    before = trace.parse(BASE, names)
    after = spans.parse(BASE + PROGRAM, names)
    read = cell.metric_reader(name)
    assert read(_ctx(after, True)) == read(_ctx(before))
    assert trace.breakdown(after) == trace.breakdown(before)
    assert after["gaps"] == before["gaps"] and after["busy_s"] == before["busy_s"]
    # unfiltered, the port's spans would relabel the idle gaps
    assert trace.parse(BASE + PROGRAM, names)["gaps"] != before["gaps"]


def test_parse_names_the_port_spans_of_each_operation():
    tr = spans.parse(BASE + PROGRAM, (run.BAND_SPAN,))
    by = {o["name"]: set(o["spans"]) for o in tr["ops"]}
    assert by["k6"] == {"fusbench.band", "fus.band", "fus.loop.march", "fus.rk_record"}
    assert by["copy"] == by["k6"] | {"fus.band.cells"}
    assert by["k2"] == {"fus.loop.sensor_plan", "fus.rk_record"} and by["early"] == set()
    assert {"fus.band", run.BAND_SPAN} <= set(tr["spans_found"])
    assert tr["idle_by_program_span"] == spans.idle_by_program_span(BASE + PROGRAM)


def test_band_launches_per_step_reads_the_port_span_or_the_benchmarks():
    read = cell.metric_reader("band.launches_per_step")
    ported = spans.parse(BASE + PROGRAM, (run.BAND_SPAN,))
    own = trace.parse(BASE, (run.BAND_SPAN,))
    assert read(_ctx(ported)) == read(_ctx(own)) == 2 / 4
    flat = trace.parse([e for e in BASE if e["name"] != run.BAND_SPAN], (run.BAND_SPAN,))
    assert read(_ctx(flat)) is None


REGISTRY = {
    "fus.setup": {"calls": 1, "total_s": 20.0, "self_s": 0.2, "parent": None},
    "fus.setup.library": {"calls": 3, "total_s": 0.9, "self_s": 0.6, "parent": None},
    "fus.setup.mesh": {"calls": 1, "total_s": 1.5, "self_s": 1.5, "parent": "fus.setup"},
    "fus.setup.operators": {"calls": 1, "total_s": 4.0, "self_s": 3.0,
                            "parent": "fus.setup.assembly"},
    "fus.setup.assembly": {"calls": 1, "total_s": 18.0, "self_s": 2.5, "parent": "fus.setup"},
    "fus.setup.source": {"calls": 1, "total_s": 9.0, "self_s": 8.5,
                         "parent": "fus.setup.assembly"},
    "fus.setup.upload": {"calls": 40, "total_s": 1.5, "self_s": 1.5,
                         "parent": "fus.setup.operators"},
    "fus.setup.stable_dt": {"calls": 1, "total_s": 1.2, "self_s": 0.7, "parent": "fus.setup"},
    "fus.rk_record": {"calls": 8, "total_s": 40.0, "self_s": 0.01, "parent": None},
    "fus.loop.step_build": {"calls": 8, "total_s": 0.004, "self_s": 0.004,
                            "parent": "fus.rk_record"},
    "fus.loop.sensor_plan": {"calls": 8, "total_s": 0.196, "self_s": 0.196,
                             "parent": "fus.rk_record"},
}
READS = {"setup.library_s": 0.6, "setup.mesh_s": 1.5, "setup.operators_s": 3.0,
         "setup.assembly_s": 2.5, "setup.source_s": 8.5, "setup.upload_s": 1.5,
         "setup.stable_dt_s": 0.7, "loop.plan_ms_per_period": 25.0}


@pytest.mark.parametrize("name", sorted(READS))
def test_program_span_readers(name):
    read = cell.metric_reader(name)
    assert read({"spans": REGISTRY}) == pytest.approx(READS[name])
    assert read({"spans": {}}) is None and read({}) is None


def test_program_metrics_have_readers_and_the_manifest_form():
    ends = {m["name"] for m in cell.load_manifest()["end_to_end"]}
    assert sorted(m["name"] for m in spans.PROGRAM_METRICS) == sorted(READS)
    for m in spans.PROGRAM_METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in ends and callable(cell.metric_reader(m["name"]))
        assert set(m["workloads"]) <= {w["name"] for w in cell.load_manifest()["workloads"]}


def test_program_spans_on_wraps_the_run_for_its_scope():
    saved = (trace.parse, cell.resolve, cell.metric_reader, run.run_cell)
    with spans.program_spans_on():
        names = {m["name"] for m in cell.resolve("h101-bowl")["per_layer"]}
        assert set(READS) <= names
        flat = {m["name"] for m in cell.resolve("h101-flat")["per_layer"]}
        assert "setup.stable_dt_s" not in flat and "setup.source_s" in flat
        assert cell.metric_reader("setup.mesh_s")({}) is None  # the port's registry is empty
        assert "idle_by_program_span" in trace.parse(BASE + PROGRAM, ())
    assert (trace.parse, cell.resolve, cell.metric_reader, run.run_cell) == saved
    assert {m["name"] for m in cell.resolve("h101-bowl")["per_layer"]} & set(READS) == set()
