"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's (float32 with
TF32 products in the stiffness, for a configuration that states float32
with TF32 off), over the same sampled period from the same start, and held
against the float64 reference by the same numbers. Its readings set the
upper end of each limit (PERF.md); the benchmark's runs never run it.

    python3 -m fusbench.control --workload <name> --seeds <n> [<n> ...]

prints one JSON line per seed: the control's ``trace_err`` and
``state_err`` over period 0 of the window that seed starts, and what the
run's own comparison (``check.judge`` with the cell's limits) makes of
them: ``correct`` has to come out false on every seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from fusbench import cell, check
from fusbench.run import axial_points


def control_readings(c: dict, seeds, device) -> list[dict]:
    """The control's readings on period 0 of each seed's window."""
    config, traffic = c["config"], c["traffic"]
    refs = cell.reference_side(config["entry"])
    ref = refs.Reference(config, traffic, device)
    ctl = refs.Reference(config, traffic, device, tf32=True)
    points = axial_points(config)
    sensors = ref.disc.locate(points)
    gdims, T = ref.disc.gdims, 1.0 / config["f0"]
    out = []
    for seed in seeds:
        u, v, t0 = refs.start_state(config, traffic, gdims, device, torch.float32, seed)
        uc, vc, traces = ctl.march(u.clone(), v.clone(), t0, t0 + T, sensors)
        res = check.check_periods(ref, [(0, t0, t0 + T, (u, v), traces, (uc, vc))], sensors)
        limits = {n: traffic["limits"][n] for n in res["worst"]}
        correct, checks = check.judge(res["worst"], limits)
        out.append({"seed": seed, **res["worst"], "correct": correct, "checks": checks})
        del u, v, uc, vc
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fusbench.control: no CUDA device", file=sys.stderr)
        return 2
    c = cell.resolve(args.workload)
    for r in control_readings(c, args.seeds, torch.device("cuda", 0)):
        print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0), **r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
