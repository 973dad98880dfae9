"""Named wall-clock timers (port of ``fenicsxfus_tpu/analysis/timing.py``;
reference: ``dolfinx::common::Timer`` scopes + ``list_timings`` tables,
``cpp/fenicsx-sf/experiments/measure_fraction_of_peak_performance/
main.cpp:112-121``).

A timed scope that hands over its result waits for the device work that
feeds it (``sync``): ``torch.cuda.synchronize`` of the result's card, and
nothing on the CPU, where torch runs each op before it returns.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_records: dict[str, list[float]] = defaultdict(list)


def sync(x) -> None:
    """Wait for the device work feeding ``x``: ``torch.cuda.synchronize`` of
    its card if it is a CUDA tensor; nothing for a CPU tensor or anything
    else."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


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
    """Formatted table of recorded timings (wall, reduced over repeats)."""
    lines = [f"{'name':<48} {'reps':>5} {'wall (s)':>12}"]
    for name in sorted(_records):
        vals = _records[name]
        lines.append(f"{name:<48} {len(vals):>5} {reduction(vals):>12.6f}")
    out = "\n".join(lines)
    if clear:
        _records.clear()
    return out


def reset_timings() -> None:
    _records.clear()
