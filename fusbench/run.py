"""One run of one benchmark cell of the port (``fenicsxfus_tpu_torch``) on
the card:

    python3 -m fusbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up imports the port, loads its CUDA library, builds the cell's model
through the program side of the configuration's entry (``entries/<entry>.py``,
over ``fusbench.program``), makes the window's start from the seed (the
entry's reference side, by default ``fusbench.start``) and warms up on one
source period from it. The window then marches one period at a time
(``march_period``: ``model.rk_record``) on the cell's axial sensors, each
period's traces copied to the host before the next starts (one client,
closed loop), until ``--seconds`` have passed. With ``--trace 1`` a few more
periods run under the profiler and the per-layer metrics are read from that
trace. Then the program's state is freed and the entry's plain reference
(``reference/entries/<entry>.py``) checks a sample of the window's periods
(``fusbench.check``).

The last line on standard output is the result, a JSON object; the numbers
compared for ``correct`` are the last lines on standard error. Without a
CUDA device, or with fewer than the cell asks for, the run prints no result
and exits with 2; if JAX or the JAX package was imported, with 3.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

_T_IMPORT = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fusbench import cell, check, program, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fenicsxfus_tpu")
BAND_SPAN = "fusbench.band"
PLAN_SPANS = ("fusbench._make_step", "fusbench._record_plan")


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc against
    the boot clock), or since this module was imported where /proc is not
    readable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        if 0.0 <= age < 86400.0:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared as whole names."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def axial_points(config: dict) -> np.ndarray:
    """The cell's sensors: ``count`` points on the axis from 0 to
    ``axis_length``, [3, count]."""
    s = config["sensors"]
    x = np.linspace(0.0, s["axis_length"], s["count"])
    return np.stack([x, np.zeros_like(x), np.zeros_like(x)])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def snapshot(bufs, tensors) -> tuple:
    """Copy ``tensors`` into the host buffers ``bufs`` and return them. A
    function, so that no name outlives the copy: a loop variable left
    holding the state would keep it alive on the card through the next
    period and raise the memory peak by a field."""
    for buf, x in zip(bufs, tensors):
        buf.copy_(x)
    return bufs


def card_info(device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={torch.device(device).index or 0}"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def run_cell(c: dict, seed: int, seconds: float, traced: bool, device) -> dict:
    """One run of the resolved cell ``c`` (``cell.resolve``) on ``device``:
    the result's fields, the checks last."""
    config, traffic = c["config"], c["traffic"]
    prog = cell.program_side(config["entry"])
    refs = cell.reference_side(config["entry"])
    device = torch.device(device)
    on_card = device.type == "cuda"
    if config.get("tf32") is False:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ---- set-up: the port, the model, the start, one warm period
    build = program.import_port()
    import_s = process_age_s()
    t0 = time.perf_counter()
    model, spp = prog.build_model(config, traffic, device)
    sync(device)
    model_s = time.perf_counter() - t0
    gdims = prog.lattice_shape(model)
    ndofs = int(np.prod(gdims))
    dtype = prog.state(model)[0].dtype
    points = axial_points(config)
    T = 1.0 / config["f0"]
    u, v, t_s = refs.start_state(config, traffic, gdims, device, dtype, seed)
    prog.set_state(model, u, v)
    del u, v
    t1 = time.perf_counter()
    prog.march_period(model, t_s, t_s + T, points).cpu()
    warm_s = time.perf_counter() - t1
    prog.set_state(model, None, None)  # the warm state goes before the start is made again
    u, v, _ = refs.start_state(config, traffic, gdims, device, dtype, seed)
    prog.set_state(model, u, v)
    del u, v
    # host buffers for the window's three state snapshots, made here (pinned on a
    # card) so that a snapshot in the window is one device-to-host copy and
    # allocates nothing
    snap_bufs = [tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=on_card)
                       for x in prog.state(model)) for _ in range(3)]
    sync(device)
    setup_s = process_age_s()

    # ---- the window
    rng = np.random.default_rng(seed)
    expected = seconds / max(warm_s, 1e-6)
    later = 1 + int(rng.uniform(0.0, 0.5) * max(expected - 3.0, 0.0))
    snap_at = {1, later, later + 1}
    snaps, traces, latency = {}, [], []
    snap_s = 0.0
    k = 0
    w0 = time.perf_counter()
    while True:
        if k in snap_at:
            ts = time.perf_counter()
            snaps[k] = snapshot(snap_bufs[len(snaps)], prog.state(model))
            snap_s += time.perf_counter() - ts
        t_k = t_s + k * T
        tic = time.perf_counter()
        ys = prog.march_period(model, t_k, t_k + T, points).cpu()
        toc = time.perf_counter()
        latency.append(toc - tic)
        traces.append(ys)
        k += 1
        if toc - w0 >= seconds and k >= 2:
            break
    window_s = toc - w0
    periods = k
    steps = sum(int(y.shape[0]) for y in traces)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # ---- the traced periods (--trace 1)
    tr = None
    if traced:
        from torch.autograd.profiler import record_function

        def spanned(fn):
            def inner(*a, **kw):
                with record_function(BAND_SPAN):
                    return fn(*a, **kw)
            return inner

        prog.wrap_band(model, spanned)

        def named(name, fn):
            def inner(*a, **kw):
                with record_function(f"fusbench.{name}"):
                    return fn(*a, **kw)
            return inner

        prog.wrap_plan(model, named)
        n_tr = int(traffic["trace_periods"])

        def traced_periods():
            for i in range(n_tr):
                t_i = t_s + (periods + i) * T
                prog.march_period(model, t_i, t_i + T, points).cpu()

        tr = trace.profile(traced_periods, span_names=(BAND_SPAN, *PLAN_SPANS))
        tr["steps"] = n_tr * spp
    slab, degree = prog.slab_cells(model), int(model.degree)
    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- correctness: the reference on a sample of the window's periods
    r0 = time.perf_counter()
    ref = refs.Reference(config, traffic, device)
    sensors = ref.disc.locate(points)
    u_s, v_s, _ = refs.start_state(config, traffic, gdims, device, dtype, seed)
    samples = [(0, t_s, t_s + T, (u_s.cpu(), v_s.cpu()), traces[0].numpy(), snaps.get(1))]
    del u_s, v_s
    if later < periods and later in snaps:
        samples.append((later, t_s + later * T, t_s + (later + 1) * T, snaps[later],
                        traces[later].numpy(), snaps.get(later + 1)))
    if ref.spp == spp:
        res = check.check_periods(ref, samples, sensors)
    else:  # a step of another size: no trace lines up with the reference's
        res = {"worst": {"trace_err": math.inf, "state_err": math.inf}, "periods": []}
    readings = dict(res["worst"])
    geometry = dict(ref.geometry)  # the reference's mesh against the analytic domain (bowl)
    readings.update(geometry)
    readings["nonfinite"] = float(sum(int((~torch.isfinite(y)).sum()) for y in traces))
    readings["steps_a_period_gap"] = float(abs(ref.spp - spp))
    limits = {**traffic["limits"], "nonfinite": 0.0, "steps_a_period_gap": 0.0}
    correct, checks = check.judge(readings, limits)
    reference_s = time.perf_counter() - r0
    del ref

    # ---- metrics
    floor = refs.step_floor(gdims, degree, torch.finfo(dtype).bits // 8, slab)
    metrics = {}
    dev = card_info(device)
    dev["memory_peak_bytes"] = int(memory_peak)
    if traced:
        ctx = {"setup": {"model_s": model_s, "import_s": import_s}, "trace": tr,
               "steps": tr["steps"], "floor_ms": floor["bound_ms"], "band_span": BAND_SPAN}
        for m in c["per_layer"]:
            value = cell.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
    else:
        e2e = {
            "setup_s": setup_s,
            "gdof_steps_per_s": ndofs * steps / window_s / 1e9,
            "period_ms_p95": float(np.percentile(np.asarray(latency) * 1e3, 95)),
            "mem_peak_gib": memory_peak / 2**30,
        }
        for m in c["end_to_end"]:  # a split metric (``name.cell``) reads its base quantity
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
    out = {
        "correct": bool(correct),
        "attempted": periods,
        "failed": sum(1 for r in res["periods"]
                      if any(r.get(n, 0.0) > limits[n] for n in ("trace_err", "state_err")))
        + int(readings["nonfinite"] > 0),
        "metrics": metrics,
        "device": dev,
    }
    if traced:
        out["breakdown"] = trace.breakdown(tr)
    out["info"] = {
        "ndofs": ndofs, "periods": periods, "steps": steps, "steps_a_period": spp,
        "window_s": window_s, "warm_period_s": warm_s, "setup_model_s": model_s,
        "period_ms_quartiles": [float(q) for q in np.percentile(np.asarray(latency) * 1e3,
                                                                 [25, 50, 75])],
        "period_ms": [x * 1e3 for x in latency], "snapshot_s": snap_s,
        "setup_import_s": import_s, "build": build, "reference_s": reference_s,
        "sampled": res["periods"], "geometry": geometry,
        "floor_ms_per_step": floor["bound_ms"], "floor_bound_by": floor["bound_by"],
        "seed": seed,
    }
    if traced:  # host seconds a traced period in the spans around the port's calls
        out["info"]["host_span_s_per_period"] = {n: v / n_tr for n, v in tr["span_s"].items()}
        out["info"]["traced_period_s"] = tr["window_s"] / n_tr
    out["checks"] = checks
    return out


def finite(obj):
    """``obj`` with every non-finite float replaced by None, so that the
    result line is strict JSON."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = cell.resolve(args.workload)
    chips = int(c["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fusbench: the cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"fusbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(finite(out), allow_nan=False))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
