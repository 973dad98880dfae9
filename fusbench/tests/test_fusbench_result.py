"""A run's result line, and ``correct`` coming out false under the faults a
cell can have: the harness driven on the CPU at a tiny size, past its look
for a card, with the timed path broken underneath."""

import numpy as np
import pytest
import torch

from fusbench import cell, control, program, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(c, seed=123456789, seconds=0.5):
    torch.set_num_threads(2)
    return run.run_cell(c, seed, seconds, False, "cpu")


def test_result_keys_and_checks_last(tiny):
    out = _run(tiny("h101-flat"))
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {m["name"] for m in cell.resolve("h101-flat")["end_to_end"]}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}


def test_fault_state_unchanged_fails(tiny, monkeypatch):
    march = program.march_period

    def frozen(model, t0, tf, points):
        u, v = model.u_n.clone(), model.v_n.clone()
        ys = march(model, t0, tf, points)
        model.u_n, model.v_n = u, v  # the step returned its state unchanged
        return ys[:1].expand_as(ys).clone()

    monkeypatch.setattr(program, "march_period", frozen)
    out = _run(tiny("h101-flat"))
    assert not out["correct"] and out["failed"] >= 1


def test_fault_answer_altered_fails(tiny, monkeypatch):
    march = program.march_period

    def altered(model, t0, tf, points):
        ys = march(model, t0, tf, points)
        i = torch.argmax(ys.abs())
        ys.view(-1)[i] *= 1.01  # one sensor reading altered where it is produced
        return ys

    monkeypatch.setattr(program, "march_period", altered)
    out = _run(tiny("h101-flat"))
    assert not out["correct"]
    assert out["checks"]["trace_err"]["value"] > out["checks"]["trace_err"]["limit"]


@pytest.mark.parametrize("name", [w["name"] for w in cell.load_manifest()["workloads"]])
def test_control_fails_the_limits(name, tiny):
    """The TF32 control, in the program's place, reads above the cell's
    limits (here at a tiny size; the readings at the cell's size are
    PERF.md's)."""
    torch.set_num_threads(2)
    c = tiny(name, nx=16 if cell.resolve(name)["traffic"]["mesh"] == "bowl" else 8)
    limits = c["traffic"]["limits"]
    for r in control.control_readings(c, [11, 12, 13], "cpu"):
        assert r["trace_err"] > limits["trace_err"] or r["state_err"] > limits["state_err"], r
        assert r["correct"] is False, r


def test_window_keeps_the_program_state_between_periods(tiny, monkeypatch):
    """Each period starts from the state the last one left: a march that
    restarts every period from the start fails the later sample."""
    state = {}
    march = program.march_period

    def restart(model, t0, tf, points):
        if "u" not in state:
            state["u"], state["v"] = model.u_n.clone(), model.v_n.clone()
        model.u_n, model.v_n = state["u"].clone(), state["v"].clone()
        return march(model, t0, tf, points)

    monkeypatch.setattr(program, "march_period", restart)
    out = _run(tiny("h101-flat"), seconds=1.5)
    per = {p["period"]: p for p in out["info"]["sampled"]}
    assert per[0]["trace_err"] < 1e-4
    assert not out["correct"]
    assert np.isfinite(out["checks"]["state_err"]["value"])
