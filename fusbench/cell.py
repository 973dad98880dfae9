"""A cell of the benchmark, found by name: ``BENCHMARK.json`` names the cell's
configuration and traffic mix, and each lives in a file of its own
(``configs/<config>.json`` by the manifest's ``file``, ``traffic/<traffic>.json``);
each per-layer metric is read by ``metrics/<metric name>.py``. A later cell,
mix or metric is a new file, and nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(path=MANIFEST) -> dict:
    return load_json(path)


def applies(metric: dict, workload: str) -> bool:
    """Whether ``metric`` is read in the cell named ``workload``."""
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, manifest: dict | None = None) -> dict:
    """The cell named ``workload``: its manifest entry, configuration,
    traffic mix, and the end-to-end and per-layer metrics read in it."""
    manifest = manifest or load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return {
        "workload": w,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in manifest["end_to_end"] if applies(m, workload)],
        "per_layer": [m for m in manifest["per_layer"] if applies(m, workload)],
        "run_seconds": manifest["run_seconds"],
    }


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"fusbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
