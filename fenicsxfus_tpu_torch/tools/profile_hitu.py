"""Where the time of the HITU W-H101-WATER focused path goes, on one CUDA
device: per-stage times of its stage kernels by CUDA events (K2 ``focused``,
with ``FUS_STAGE_V3=0`` K5a and K5b, or with ``FUS_STEP_WAVE=1`` the one K3
launch per step), the sensor gather, the host-clock step time of
``rk_record``, and a ``torch.profiler`` window of 10 ``rk_record`` steps
(device busy share). With ``--bowl``, the same for the bowl-fitted mesh at
the defaults of ``drivers.hitu.build_bowl_model``: per stage, K2
``westervelt`` with its band operand and the band itself (the slab rows of
the stage fields through K6, ``ops/band.py``).

    python3 fenicsxfus_tpu_torch/tools/profile_hitu.py
    FUS_STAGE_V3=0 FUS_V3=0 python3 fenicsxfus_tpu_torch/tools/profile_hitu.py
    FUS_STEP_WAVE=1 python3 fenicsxfus_tpu_torch/tools/profile_hitu.py
    python3 fenicsxfus_tpu_torch/tools/profile_hitu.py --bowl

Runs from any directory; it imports the package of the checkout it lies in.
"""

import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from fenicsxfus_tpu_torch.analysis import timing  # noqa: E402
from fenicsxfus_tpu_torch.drivers import hitu  # noqa: E402
from fenicsxfus_tpu_torch.ops.stage import stage_apply  # noqa: E402
from fenicsxfus_tpu_torch.ops.stage_ab import stage_a_apply, stage_b_apply  # noqa: E402
from fenicsxfus_tpu_torch.ops.step_wave import (  # noqa: E402
    FusedRKStepWave, step_wave_apply, step_wave_check,
)


def main() -> None:
    dev = torch.device("cuda", 0)
    bowl = "--bowl" in sys.argv[1:]
    t0 = time.perf_counter()
    build = hitu.build_bowl_model if bowl else hitu.build_model
    with timing.tracing():
        model, _, dt, _ = build("W", "H101", "WATER", 80, f0=0.5e6, device=dev)
    torch.cuda.synchronize()
    print(f"setup {time.perf_counter() - t0:.2f} s, {model.number_of_dofs()} DOF, dt {dt:.6e} s",
          flush=True)
    print(timing.list_timings(), flush=True)
    pts = hitu.axial_points("H101")
    # past the source ramp, so no value is trivial
    model.rk_record(0.0, 400 * dt, pts)
    torch.cuda.synchronize()

    # per-stage (K3: per-step) kernel times over 5 steps
    wave = model.stage_cls is FusedRKStepWave
    two_kernel = os.environ.get("FUS_STAGE_V3", "1") == "0"
    names = ("K3",) if wave else ("K5a", "K5b") if two_kernel else ("K2",)
    if bowl:  # the band (stage fields' slab rows and K6), then K2 with it
        names = ("band", "K2+band")
    slots = 1 if wave else 4  # launches of each kernel per step
    events = {(n, i): [] for n in names for i in range(slots)}
    calls = {n: 0 for n in names}

    def timer(fn, name):
        def timed(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            events[(name, calls[name] % slots)].append((a, b))
            calls[name] += 1
            return out
        return timed

    if wave:
        stage_fn = timer(step_wave_apply, "K3")
    elif two_kernel:
        time_a, time_b = timer(stage_a_apply, "K5a"), timer(stage_b_apply, "K5b")

        def stage_fn(kind, u0, v0, kvp, kvpp, prev, Fs, dense, facets, scal, p, final):
            yA = time_a(kind, u0, v0, kvp, kvpp, Fs, scal, p)
            return time_b(kind, u0, v0, kvp, kvpp, prev, yA, Fs, dense, facets, scal, p, final)
    elif bowl:
        stage_fn = timer(stage_apply, "K2+band")
        band_fn = model._band_fn
        model._band_fn = lambda keys: timer(band_fn(keys), "band")
    else:
        stage_fn = timer(stage_apply, "K2")

    step = model.fused_step(stage_fn=stage_fn)
    gd = model.ops.gdims
    u, v, t = model.u_n.view(gd), model.v_n.view(gd), model.t
    for _ in range(5):
        u, v, t = step(model.consts, (u, v, t), dt)
    torch.cuda.synchronize()
    step_wave_check()
    total = 0.0
    for n in names:
        per = [float(np.median([a.elapsed_time(b) for a, b in events[(n, i)]]))
               for i in range(slots)]
        total += sum(per)
        print(f"{n} {model.FUSED_KIND} per {'step' if wave else 'stage'} (median of 5 steps, "
              "CUDA events): "
              + " / ".join(f"{x:.3f}" for x in per) + f" ms; sum {sum(per):.3f} ms", flush=True)
    print(f"stage kernels per step: {total:.3f} ms ({torch.cuda.get_device_name(0)})", flush=True)

    # sensor gather
    extract = model._record_plan(pts)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    extract(u)
    a.record()
    for _ in range(100):
        extract(u)
    b.record()
    b.synchronize()
    print(f"sensor gather: {a.elapsed_time(b) / 100 * 1e3:.2f} us per step (mean of 100)",
          flush=True)

    # host-clock step time of the recording loop, two 50-step windows
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.rk_record(model.t, model.t + 50 * dt, pts)
        torch.cuda.synchronize()
        print(f"rk_record 50 steps: {(time.perf_counter() - t1) / 50 * 1e3:.3f} ms per step "
              "(host clock)", flush=True)

    # profiler window: 10 steps of rk_record
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        model.rk_record(model.t, model.t + 10 * dt, pts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    rows, busy = device_ops(prof)
    for d, k, c in rows[:8]:
        print(f"  device {d:9.3f} ms  x{c:5d}  {k[:90]}")
    print(f"profiled 10 steps: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms, "
          f"busy share {busy / (wall * 1e3):.3f}", flush=True)


def device_ops(prof) -> tuple[list, float]:
    """The device operations of a ``torch.profiler`` window, largest first:
    ([(self device ms, name, calls)], their sum in ms)."""
    rows = []
    for e in prof.key_averages():
        d = getattr(e, "self_device_time_total", None)
        if d is None:
            d = getattr(e, "self_cuda_time_total", 0.0)
        if d and e.device_type is not None and "CUDA" in str(e.device_type):
            rows.append((d / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows)


if __name__ == "__main__":
    main()
