"""What decides ``correct``: the window's sensor traces and states held
against the plain reference (``fusbench.reference``), in float64.

The window marches source periods one at a time; the reference cannot march
them all in less time than the window took, so it checks a sample: period 0
from the seed's start state (which the benchmark made, so the reference
starts where the program did), and one later period drawn from the seed,
from the program's own state at that period's start (a host copy taken in
the window). Each is compared by

* ``trace_err``: the largest gap between the program's and the reference's
  sensor traces over the period's steps and sensors, over the reference's
  largest |trace|;
* ``state_err``: the larger of ||u - u_ref|| / ||u_ref|| and
  ||v - v_ref|| / ||v_ref|| at the period's end (the program's state at the
  next period's start);

and every trace value of every period of the window is finite
(``nonfinite``, an exact count with the limit 0). The limits are the
traffic file's ``limits``.
"""

from __future__ import annotations

import numpy as np
import torch


def rel_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """max |prog - ref| / max |ref|."""
    return float(np.max(np.abs(prog - ref)) / np.max(np.abs(ref)))


def state_gap(prog, ref) -> float:
    """The larger relative L2 gap of (u, v) against the reference's."""
    gaps = []
    for p, r in zip(prog, ref):
        p = torch.as_tensor(p).to(device=r.device, dtype=torch.float64).reshape(-1)
        r = r.reshape(-1).to(torch.float64)
        gaps.append(float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r)))
    return max(gaps)


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each reading at or under its
    limit; a missing or non-finite reading fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and np.isfinite(value) and value <= limit
        ok = ok and bool(good)
        out[name] = {"value": value, "limit": limit}
    return ok, out


def check_periods(ref, samples, sensors) -> dict:
    """March the reference ``ref`` over each sample (k, t0, t1, start (u, v),
    program traces [steps, n], program end state (u, v) or None) and return
    the worst ``trace_err`` and ``state_err`` and each period's readings."""
    worst = {"trace_err": None, "state_err": None}
    per = []
    for k, t0, t1, start, traces, end in samples:
        u0, v0 = (torch.as_tensor(x).to(device=ref.disc.device, dtype=ref.disc.dtype).reshape(-1)
                  for x in start)
        u, v, ref_traces = ref.march(u0, v0, t0, t1, sensors)
        r = {"period": k, "trace_err": rel_gap(np.asarray(traces, np.float64), ref_traces)}
        if end is not None:
            r["state_err"] = state_gap(end, (u, v))
        per.append(r)
        for name in worst:
            if name in r:
                worst[name] = r[name] if worst[name] is None else max(worst[name], r[name])
        del u, v
    return {"worst": worst, "periods": per}
