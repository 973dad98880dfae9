"""Named wall-clock timers and the port's spans (port of
``fenicsxfus_tpu/analysis/timing.py``; reference: ``dolfinx::common::Timer``
scopes + ``list_timings`` tables, ``cpp/fenicsx-sf/experiments/
measure_fraction_of_peak_performance/main.cpp:112-121``).

A timed scope that hands over its result waits for the device work that
feeds it (``sync``): ``torch.cuda.synchronize`` of the result's card, and
nothing on the CPU, where torch runs each op before it returns. ``Timer``
and ``timeit_device`` always record: they are the operator's explicit
timers.

Spans mark the phases of the port's own work (``span`` as a context
manager, ``traced`` as a decorator). They are off unless ``FUS_TRACE=1`` is
set when this module is imported (the package's first import, so its own
imports and the library loads are spanned too), or ``tracing()`` switches
them on for a scope. Off, a span is one test of a module global that
returns a shared no-op: nothing is recorded and no profiler range opens.
On, spans nest through a per-thread stack, and the registry keeps for each
name its calls, total seconds, self seconds (the total less its children's
totals) and the parent of its first call, never a list per call
(``snapshot``); each span also opens ``torch.profiler.record_function(name)``,
so a profiler's trace shows it on the same clock as the device's
operations, with the kernels launched inside it. ``sync`` waits for the
device before the span closes: set-up spans only, never inside the time
loop, where a wait would change what it measures.

The spans the port opens:

* ``fus.import``: the package's own imports (``__init__.py``);
* ``fus.setup.library``: the CUDA library's and the native geometry
  library's check, compile if needed, and load (``_build.py``,
  ``native/``);
* ``fus.setup``: a driver's model entry (``drivers/hitu.py::build_model``,
  ``build_bowl_model``, ``drivers/ph1.py::build_model``), closing with a
  sync, and inside it ``fus.setup.mesh``, ``fus.setup.context`` (the first
  touch of the card, ``utils.init_device``), ``fus.setup.assembly`` (media,
  the model's constructor and ``init()``), ``fus.setup.operators``
  (``SEMOperators.__init__``), ``fus.setup.source`` (the transducer's
  drive vectors), ``fus.setup.upload`` (``SEMOperators.to_device``, closing
  with a sync) and ``fus.setup.stable_dt`` (``utils.estimate_stable_dt``);
* ``fus.rk_record``: one ``rk_record`` call, and inside it
  ``fus.loop.step_build``, ``fus.loop.sensor_plan`` and ``fus.loop.march``;
* ``fus.band``: one call of the slab correction K6
  (``SEMOperators.band_correction_rows``), and inside it
  ``fus.band.gather``, ``fus.band.cells`` and ``fus.band.scatter``.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch
from torch.autograd.profiler import record_function

_records: dict[str, list[float]] = defaultdict(list)
# span name -> [calls, total seconds, self seconds, parent name of the first call]
_spans: dict[str, list] = {}
_lock = threading.Lock()
_local = threading.local()
_on = os.environ.get("FUS_TRACE", "") == "1"


def sync(x) -> None:
    """Wait for the device work feeding ``x``: ``torch.cuda.synchronize`` of
    its card if it is a CUDA tensor; nothing for a CPU tensor or anything
    else."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def _wait(device) -> None:
    """Wait for ``device`` (a CUDA device; nothing for the CPU), or with
    ``True`` for the current CUDA device if CUDA has been initialised."""
    if device is True:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Off:
    """The span of tracing off, shared by every call: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "sync", "_range", "_t0", "_children")

    def __init__(self, name: str, sync):
        self.name, self.sync = name, sync

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        self._children = 0.0
        stack = _local.__dict__.setdefault("stack", [])
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if self.sync is not None and exc[0] is None:
                _wait(self.sync)
        finally:
            dt = time.perf_counter() - self._t0
            stack = _local.stack
            stack.pop()
            parent = stack[-1] if stack else None
            if parent is not None:
                parent._children += dt
            with _lock:
                rec = _spans.get(self.name)
                if rec is None:
                    rec = _spans[self.name] = [0, 0.0, 0.0, parent and parent.name]
                rec[0] += 1
                rec[1] += dt
                rec[2] += dt - self._children
            self._range.__exit__(*exc)
        return False


def span(name: str, sync=None):
    """A span of the port's work named ``name``, as a context manager. Off:
    the shared no-op. ``sync`` (a device, or ``True`` for the current CUDA
    device) waits for that device before the span closes."""
    if not _on:
        return _OFF
    return _Span(name, sync)


def traced(name: str, sync=None):
    """Decorator: each call of the function runs inside ``span(name,
    sync)``. The switch is read at each call, not when the function is
    decorated, so ``tracing()`` reaches decorated functions too."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, sync):
                return fn(*args, **kwargs)

        return inner

    return wrap


@contextmanager
def tracing(on: bool = True):
    """Switch spans on (or off) for the scope, then back as they were."""
    global _on
    was, _on = _on, bool(on)
    try:
        yield
    finally:
        _on = was


def snapshot() -> dict:
    """The spans recorded so far: {name: {calls, total_s, self_s, parent}}."""
    with _lock:
        return {n: {"calls": c, "total_s": t, "self_s": s, "parent": p}
                for n, (c, t, s, p) in _spans.items()}


@contextmanager
def Timer(name: str, result=None):
    """Time a scope; pass the output tensor as ``result`` to include device
    execution (not just the launches) in the measurement."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if result is not None:
            sync(result)
        _records[name].append(time.perf_counter() - t0)


def timeit_device(name: str, fn, *args, n: int = 10, warmup: int = 1) -> float:
    """Min-of-n wall time of ``fn(*args)`` including its device work (the
    reference records the min over runs in ``operator_timings_min.txt``)."""
    for _ in range(warmup):
        sync(fn(*args))
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    _records[name].append(best)
    return best


def list_timings(reduction=min, clear: bool = False) -> str:
    """Formatted table of recorded timings (wall, reduced over repeats),
    then, if any span was recorded, the spans' calls, total and self
    seconds."""
    lines = [f"{'name':<48} {'reps':>5} {'wall (s)':>12}"]
    for name in sorted(_records):
        vals = _records[name]
        lines.append(f"{name:<48} {len(vals):>5} {reduction(vals):>12.6f}")
    spans = snapshot()
    if spans:
        lines.append(f"{'span':<48} {'calls':>7} {'total (s)':>12} {'self (s)':>12}")
        for name in sorted(spans):
            s = spans[name]
            lines.append(f"{name:<48} {s['calls']:>7} {s['total_s']:>12.6f} {s['self_s']:>12.6f}")
    out = "\n".join(lines)
    if clear:
        reset_timings()
    return out


def reset_timings() -> None:
    """Forget every timer's and every span's records."""
    _records.clear()
    with _lock:
        _spans.clear()
