"""Where the step time of an unstructured solve goes: the port of
``benchmarks/unstructured_trace.py``.

The linear model (c0 1.5, ρ0 1, f0 10, p0 1, source on x = 0, ABC on x = 1,
dt = 0.4·h_min/(c0·p²)) on the distorted unit box of
``tools/unstructured_solve.py::distorted_box`` (interior vertices jittered
by 0.15·h, vertex ids permuted: the general per-cell path; the default
nx = 24 at p = 4: 912,673 DOF), fp32: a warm-up window of ``steps`` RK4
steps from t = 0 (each window restarts the source clock at 0 and carries
the state, as the JAX script does), the same window again timed on the host clock to a device sync,
then the same window under ``torch.profiler`` with the largest device
operations (gather, the per-cell products, the fold, the elementwise
passes; ``tools/profile_hitu.py::device_ops``) and the device's busy
share of the window.

    python -m fenicsxfus_tpu_torch.tools.unstructured_trace [--nx 24] [--steps 6]

On the CPU (``--device cpu``) the steps run and nothing is timed or traced.
"""

from __future__ import annotations

import time

import torch

from ..models.linear import LinearSpectralExplicit
from ..scripts import cli, device_dtype
from .unstructured_solve import distorted_box


TOP = 25  # device operations printed, as the JAX script's summary


def main(nx: int = 24, steps: int = 6, degree: int = 4, dtype=None, device="cuda") -> dict:
    """The timed window (None on the CPU), the profiled window's device
    operations, and the state ``u`` after the three windows."""
    dev, dtype = device_dtype(device, dtype, cpu_dtype=torch.float32)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    mesh = distorted_box(nx)
    c0, rho0, f0, p0 = 1.5, 1.0, 10.0, 1.0
    dt = 0.4 * mesh.h_min() / (c0 * degree**2)
    model = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt, dtype=dtype,
                                   device=dev)
    model.init()
    n = model.number_of_dofs()
    print(f"unstructured linear: nx={nx} p={degree} {n / 1e6:.2f}M DOF, {dtype}, "
          f"{'general' if model.ops.lattice is None else 'lattice'} path")
    model._build()
    solve, consts = model._solve, model.consts
    u, v = model.u_n, model.v_n
    t0 = time.perf_counter()
    u, v, t = solve(consts, u, v, 0.0, steps * dt, dt)
    sync()
    warmup = time.perf_counter() - t0
    t0 = time.perf_counter()
    u, v, t = solve(consts, u, v, 0.0, steps * dt, dt)
    sync()
    wall = time.perf_counter() - t0
    out = {"ndofs": n, "steps": steps, "step_kind": model.step_kind, "warmup_s": warmup}
    if not cuda:
        print(f"{steps} steps on the CPU: not timed, not traced")
        u, v, t = solve(consts, u, v, 0.0, steps * dt, dt)
        return {**out, "wall_s": None, "ms_step": None, "rate": None, "ops": [],
                "busy_ms": None, "u": u}
    print(f"warm-up {warmup:.2f} s; {steps} steps in {wall * 1e3:.1f} ms -> "
          f"{wall / steps * 1e3:.2f} ms/step, {n * steps / wall / 1e9:.4f} GDOF-RK4-steps/s")
    from torch.profiler import ProfilerActivity, profile

    from .profile_hitu import device_ops

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        u, v, t = solve(consts, u, v, 0.0, steps * dt, dt)
        sync()
        pwall = time.perf_counter() - t1
    ops, busy = device_ops(prof)
    for d, k, c in ops[:TOP]:
        print(f"  device {d:9.3f} ms  x{c:5d}  {k[:90]}")
    print(f"profiled {steps} steps: wall {pwall * 1e3:.2f} ms, device busy {busy:.2f} ms, busy "
          f"share {busy / (pwall * 1e3):.3f} ({torch.cuda.get_device_name(dev)})")
    return {**out, "wall_s": wall, "ms_step": wall / steps * 1e3,
            "rate": n * steps / wall / 1e9, "ops": ops[:TOP], "busy_ms": busy,
            "profiled_wall_ms": pwall * 1e3, "u": u}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
