"""A traced run of one cell with the port's own spans on:

    python3 -m fusbench.spans --workload <name> --seed <n> --seconds <s>

It is ``python3 -m fusbench.run ... --trace 1`` with the spans of
``fenicsxfus_tpu_torch/analysis/timing.py`` switched on: ``FUS_TRACE=1`` is
set before the port is imported, the profiler's trace is read for the
port's ``fus.*`` spans beside the benchmark's own, and the per-layer metrics
that read them (``PROGRAM_METRICS``; one reader a metric in ``metrics/``,
as every metric) get a context that also holds ``spans``, the port's
registry after the traced periods (``timing.snapshot()``). ``run.py`` is
left as it is: ``program_spans_on`` wraps its ``trace.parse``,
``cell.resolve``, ``cell.metric_reader`` and ``run_cell`` for this
process. The result line is ``run.py``'s, with those metrics, and in
``info`` ``program_spans`` (the snapshot) and ``idle_by_program_span``.

The readers that ``run.py``'s own traced run has, and ``breakdown``, read
what they read there: their trace is parsed from the events without the
port's spans, and only each operation's ``spans``, ``spans_found`` and
``span_s`` gain the port's span names (``parse``). The spans are on in the
whole run, so its window and its set-up carry their cost: ``info``'s
``window_s`` and ``setup_model_s`` against an untraced run's measure it.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict
from contextlib import contextmanager

from fusbench import trace

PREFIX = "fus."
_parse = trace.parse  # the benchmark's own, which ``program_spans_on`` wraps
CELLS = ["h101-flat", "h101-bowl", "ph1-sc2-bm7-p5", "ph1-sc2-bm6"]


def _metric(name, unit, layer, moves, workloads=CELLS):
    return {"name": name, "unit": unit, "better": "lower", "source": "program_span",
            "layer": layer, "moves": moves, "workloads": list(workloads)}


# the per-layer metrics that read the port's registry (``ctx["spans"]``)
PROGRAM_METRICS = [
    *(_metric(f"setup.{ph}_s", "s", "host set-up", "setup_s")
      for ph in ("library", "mesh", "operators", "assembly", "source", "upload")),
    _metric("setup.stable_dt_s", "s", "host set-up", "setup_s", ["h101-bowl"]),
    _metric("loop.plan_ms_per_period", "ms/period", "time loop and sensors",
            "gdof_steps_per_s"),
]


def _is_program_span(e) -> bool:
    return (e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PREFIX))


def _innermost(spans) -> list:
    """Properly nested spans [(start, end, name)] of one thread as
    [(start, end, name of the innermost span)] segments, in order,
    covering their union. A child that outlasts its parent by the trace's
    rounding is cut at the parent's end."""
    out, stack, cur = [], [], 0.0

    def close(t):
        nonlocal cur
        while stack and stack[-1][1] <= t:
            _, e, n = stack.pop()
            if cur < e:
                out.append((cur, e, n))
                cur = e

    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        close(s)
        if stack:
            if cur < s:
                out.append((cur, s, stack[-1][2]))
            e = min(e, stack[-1][1])
        cur = s
        stack.append((s, e, n))
    close(float("inf"))
    return out


def idle_by_program_span(events) -> dict:
    """The device's idle seconds from the start of the first ``fus.rk_record``
    span to the end of the last device operation or port span, split by the
    innermost port span (on the thread of that first ``fus.rk_record``) that
    covers each idle instant, by overlap; what no span covers is
    ``"none"``. Empty where the trace has no ``fus.rk_record``."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"], e.get("tid"))
             for e in events if _is_program_span(e)]
    records = [s for s in spans if s[2] == PREFIX + "rk_record"]
    if not records:
        return {}
    t0, _, _, tid = min(records)
    spans = [(s, e, n) for s, e, n, t in spans if t == tid]
    ops = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
           if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS]
    t1 = max([e for _, e in ops] + [e for _, e, _ in spans])
    busy = trace._merge([(max(s, t0), min(e, t1)) for s, e in ops if e > t0 and s < t1])
    idle, cur = [], t0
    for s, e in busy:
        if cur < s:
            idle.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        idle.append((cur, t1))
    segs = _innermost(spans)
    out = defaultdict(float)
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(segs) and segs[k][0] < b:
            over = min(b, segs[k][1]) - max(a, segs[k][0])
            if over > 0:
                out[segs[k][2]] += over * 1e-6
                covered += over
            k += 1
        out["none"] += (b - a - covered) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def parse(events, span_names=()) -> dict:
    """``trace.parse`` of the events without the port's spans, whose
    operations' ``spans``, ``spans_found`` and ``span_s`` also name the
    port's spans, with ``idle_by_program_span``."""
    out = _parse([e for e in events if not _is_program_span(e)], span_names)
    ours = sorted({e["name"] for e in events if _is_program_span(e)})
    full = _parse(events, tuple(span_names) + tuple(ours))
    for o, f in zip(out["ops"], full["ops"]):
        o["spans"] = f["spans"]
    out["spans_found"], out["span_s"] = full["spans_found"], full["span_s"]
    out["idle_by_program_span"] = idle_by_program_span(events)
    return out


def _snapshot() -> dict:
    """The port's span registry (imported by then: the run has built the
    model)."""
    from fenicsxfus_tpu_torch.analysis import timing

    return timing.snapshot()


@contextmanager
def program_spans_on():
    """``run.py``'s traced run, for the scope, with the port's spans read:
    the wrapped ``trace.parse``, ``cell.resolve`` (the cell's metrics and
    the ``PROGRAM_METRICS`` it reports), ``cell.metric_reader`` (a context
    with ``spans``) and ``run.run_cell`` (the two ``info`` entries)."""
    from fusbench import cell, run

    saved = (trace.parse, cell.resolve, cell.metric_reader, run.run_cell)
    _, resolve0, reader0, run_cell0 = saved
    last = {}

    def parse_with(events, span_names=()):
        last["trace"] = parse(events, span_names)
        return last["trace"]

    def resolve_with(workload, manifest=None):
        c = resolve0(workload, manifest)
        c["per_layer"] = c["per_layer"] + [m for m in PROGRAM_METRICS
                                           if cell.applies(m, workload)]
        return c

    def reader_with(name):
        read = reader0(name)
        return lambda ctx: read({**ctx, "spans": _snapshot()})

    def run_cell_with(*args, **kwargs):
        out = run_cell0(*args, **kwargs)
        out["info"]["program_spans"] = _snapshot()
        out["info"]["idle_by_program_span"] = last.get("trace", {}).get("idle_by_program_span")
        return out

    trace.parse, cell.resolve, cell.metric_reader, run.run_cell = (
        parse_with, resolve_with, reader_with, run_cell_with)
    try:
        yield
    finally:
        trace.parse, cell.resolve, cell.metric_reader, run.run_cell = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    os.environ["FUS_TRACE"] = "1"  # read when the port's timing module is imported
    from fusbench import run

    with program_spans_on():
        return run.main(["--workload", args.workload, "--seed", str(args.seed),
                         "--seconds", str(args.seconds), "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
