"""The harness of the kernel variant tools (``tile_variants.py``,
``wave_variants.py``): each variant is a copy of this package with a few
text changes to its sources, made under ``_build/variants/`` and built
there, all builds at once; then each runs in its own process, in turn, on
the same inputs, and its lines are printed under its name and its ptxas
lines.

A tool gives ``main`` its variants, the ptxas entries to report and its
``measure(mode)``, which runs in the variant's process (the variant's copy
first on ``sys.path``) and prints its rows.
"""

import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
VARIANT_DIR = PKG / "_build" / "variants"


def make(name: str, changes, base: Path = VARIANT_DIR) -> Path:
    """The variant's copy of the package under ``base`` (its root directory),
    each change (file relative to ``csrc/``, old text, new text) applied to
    text that occurs in that file exactly once."""
    root = base / "".join(ch if ch.isalnum() else "_" for ch in name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, old, new in changes:
        src = root / PKG.name / "csrc" / fname
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} is not once in {fname}")
        src.write_text(text.replace(old, new))
    return root


def median_ms(fn, runs: int = 10) -> float:
    """Median of ``runs`` calls of ``fn`` after one warm-up, each timed by
    CUDA events on the current stream."""
    import numpy as np
    import torch

    fn()
    ts = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def device_ms(fn, runs: int = 10, cycles: int = 4_000_000) -> float:
    """As ``median_ms``, but with the stream held busy (``torch.cuda._sleep``
    of ``cycles`` clocks, about 2 ms) while the host enqueues the events and
    ``fn``'s launches, so that the events time the device alone and not the
    wrapper's host time before its launch. ``fn`` must not synchronize."""
    import numpy as np
    import torch

    fn()
    ts = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def best_ms(run, k: int, reps: int = 3, device=None):
    """The least CUDA-event time of ``run(k)`` (which queues k chained
    units of work and must not synchronize) over ``reps`` runs after one
    warm-up: ms. None unless ``device`` is a CUDA device."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return None
    run(k)
    best = float("inf")
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run(k)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def slope_ms(run, n: int, reps: int = 3, device=None):
    """ms a unit of work as the slope between ``best_ms`` of ``run(n)`` and
    of ``run(2 * n)``, so that the fixed cost of a run (its first launch,
    the loop's set-up) cancels. None unless ``device`` is a CUDA device."""
    short = best_ms(run, n, reps, device)
    return None if short is None else (best_ms(run, 2 * n, reps, device) - short) / n


def card_ms(fn, device) -> dict:
    """{"ms": ``median_ms``, "device_ms": ``device_ms``} of ``fn`` on a CUDA
    ``device``; on the CPU both are None (not measured: no CPU time stands
    for the card's)."""
    if device.type != "cuda":
        return {"ms": None, "device_ms": None}
    return {"ms": median_ms(fn), "device_ms": device_ms(fn)}


def ptxas_lines(log: str, entries) -> list:
    """The register and spill lines of ptxas for the kernels whose mangled
    names contain one of ``entries``, each after the start of that name."""
    out, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif any(k in entry for k in entries) and ("registers" in line or "spill" in line):
            out.append(f"{entry[8:40]} " + line.replace("ptxas info    :", "").strip())
    return out


def main(tool: str, variants: dict, entries, measure, mode=lambda name: "time") -> None:
    """The command line of a variant tool (``tool`` is its file): with no
    arguments every variant, else the variants named. ``mode(name)`` is the
    argument the variant's process hands to ``measure``."""
    if len(sys.argv) > 2 and sys.argv[1] == "--in":  # a variant's own process
        sys.path.insert(0, sys.argv[2])
        from fenicsxfus_tpu_torch import _build

        if sys.argv[3] == "build":
            print("\n".join(ptxas_lines(_build.build()[2], entries)), flush=True)
        else:
            measure(sys.argv[3])
        return
    names = sys.argv[1:] or list(variants)
    roots = {n: make(n, variants[n]) for n in names}
    builds = {n: subprocess.Popen([sys.executable, tool, "--in", str(r), "build"],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for n, r in roots.items()}
    ptxas = {}
    for n, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {n!r} did not build:\n{log}")
        ptxas[n] = "; ".join(line for line in log.splitlines() if line)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    for n, r in roots.items():
        print(f"{n} [{ptxas[n]}]", flush=True)
        res = subprocess.run([sys.executable, tool, "--in", str(r), mode(n)],
                             capture_output=True, text=True, timeout=900)
        print(res.stdout.rstrip() or res.stderr.strip().splitlines()[-1], flush=True)
