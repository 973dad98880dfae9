"""A cell of the benchmark, found by name: ``BENCHMARK.json`` names the cell's
configuration and traffic mix, and each lives in a file of its own
(``configs/<config>.json`` by the manifest's ``file``, ``traffic/<traffic>.json``);
each per-layer metric is read by ``metrics/<metric name>.py``; the
configuration's ``entry`` names what it runs, in two files of its own: the
program side ``entries/<entry>.py`` and the reference side
``reference/entries/<entry>.py``. A later cell, mix, metric or entry is a
new file, and nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
# what an entry's program side may replace; ``fusbench.program`` has the default of each
PROGRAM_HOOKS = ("lattice_shape", "slab_cells", "set_state", "state", "march_period",
                 "wrap_plan", "wrap_band")


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
    traffic mix, and the end-to-end and per-layer metrics read in it. A
    configuration whose entry has not both files is refused here."""
    manifest = manifest or load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    entry_files(config["entry"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return {
        "workload": w,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in manifest["end_to_end"] if applies(m, workload)],
        "per_layer": [m for m in manifest["per_layer"] if applies(m, workload)],
        "run_seconds": manifest["run_seconds"],
    }


def _load(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"fusbench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    return _load(HERE / "metrics" / f"{name}.py", f"metric_{name.replace('.', '_')}").read


def entry_files(name: str) -> tuple[Path, Path]:
    """The program side and the reference side of the entry ``name``; an
    entry without both files is refused by name."""
    paths = (HERE / "entries" / f"{name}.py", HERE / "reference" / "entries" / f"{name}.py")
    if not NAME.fullmatch(str(name)) or not all(p.is_file() for p in paths):
        raise KeyError(f"no entry {name!r}: it needs entries/{name}.py and "
                       f"reference/entries/{name}.py under {HERE}")
    return paths


def program_side(name: str) -> SimpleNamespace:
    """The entry's program side (``entries/<name>.py``, which with
    ``fusbench.program`` builds and drives the port's model): its
    ``build_model(config, traffic, device) -> (model, steps a period)``,
    the model holding a state of its dtype and ``degree``; and
    for each of ``PROGRAM_HOOKS`` its own function or ``fusbench.program``'s,
    taken when this is called."""
    from fusbench import program

    mod = _load(entry_files(name)[0], f"entry_{name.replace('.', '_')}")
    return SimpleNamespace(build_model=mod.build_model,
                           **{h: getattr(mod, h, getattr(program, h)) for h in PROGRAM_HOOKS})


def reference_side(name: str) -> SimpleNamespace:
    """The entry's reference side (``reference/entries/<name>.py``, which
    imports nothing of the port), each its own or the explicit RK4
    Westervelt entry's default: ``Reference(config, traffic, device,
    tf32=False)``, the plain reference the check and the control build (with
    ``disc.locate(points)``, ``disc.device``, ``disc.dtype``, ``disc.gdims``,
    ``spp``, ``geometry`` and ``march(u, v, t0, tf, sensors) -> (u, v,
    traces)``; ``reference.model.ReferenceModel``);
    ``step_floor(shape, degree, itemsize, slab_cells)``, the least time of
    one step that ``kernels_roofline`` divides by (``bounds.step_floor``);
    and ``start_state``, where the state is not a lattice
    (``start.start_state``)."""
    from fusbench import bounds, start
    from fusbench.reference.model import ReferenceModel

    mod = _load(entry_files(name)[1], f"reference_{name.replace('.', '_')}")
    return SimpleNamespace(Reference=getattr(mod, "Reference", ReferenceModel),
                           step_floor=getattr(mod, "step_floor", bounds.step_floor),
                           start_state=getattr(mod, "start_state", start.start_state))
