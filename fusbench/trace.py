"""The device trace of a few periods: ``torch.profiler`` over CPU and CUDA,
exported as a Chrome trace into the run's temporary directory, read back and
deleted. From it: every device operation (kernels, copies, fills) with its
time on the device and whether the host launched it inside a named span
(``record_function``), the device's busy time (the union of the
operations' intervals), and the idle gaps between them, each labelled by
the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def profile(fn, span_names=()):
    """Run ``fn()`` under the profiler and synchronise; returns the parsed
    trace (``parse``) with ``window_s``, the host seconds of the run."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="fusbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    out = parse(events, span_names)
    out["window_s"] = window_s
    return out


def _merge(intervals):
    """The union of [start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def parse(events, span_names=()) -> dict:
    """Device operations, busy seconds and labelled idle gaps of a Chrome
    trace's ``events``. Times in the trace are microseconds."""
    launches = {}
    spans = defaultdict(list)
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e["ts"], e.get("tid"))
        if cat in HOST_CATS:
            host.append((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "?")))
            if e.get("name") in span_names:
                spans[e["name"]].append((e["ts"], e["ts"] + e.get("dur", 0), e.get("tid")))
    for ivs in spans.values():
        ivs.sort()
    span_starts = {n: [iv[0] for iv in ivs] for n, ivs in spans.items()}

    def within(name, ts, tid):
        i = bisect.bisect_right(span_starts[name], ts) - 1
        return i >= 0 and spans[name][i][1] >= ts and spans[name][i][2] == tid

    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        launch = launches.get(corr)
        inside = []
        if launch is not None:
            inside = [n for n in spans if within(n, *launch)]
        ops.append({"name": e.get("name", "?"), "start": e["ts"], "dur": e.get("dur", 0),
                    "spans": inside})
    busy = _merge([(o["start"], o["start"] + o["dur"]) for o in ops])
    gaps = []
    host.sort()
    starts = [h[0] for h in host]
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        label = "host: no operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 200, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        gaps.append((label, (s1 - e0) * 1e-6))
    return {"ops": ops, "busy_s": sum(e - s for s, e in busy) * 1e-6, "gaps": gaps,
            "spans_found": sorted(spans),
            "span_s": {n: sum(e - s for s, e, _ in ivs) * 1e-6 for n, ivs in spans.items()}}


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle gaps by what
    the host was doing, each summed by name: [[name, seconds], ...]."""
    dev = defaultdict(float)
    for o in trace["ops"]:
        dev[o["name"]] += o["dur"] * 1e-6
    idle = defaultdict(float)
    for label, s in trace["gaps"]:
        idle[label] += s
    order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": order(dev), "idle_gaps": order(idle)}
