"""Entries found by name: the four cells resolve to the functions they ran
before entries were files, an unknown entry is refused, and a new entry is
new files alone (a toy entry beside a copy of the harness, run end to end)."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest
import torch

from fusbench import bounds, cell, program, start
from fusbench.reference.model import ReferenceModel
from fusbench.tests.conftest import ROOT

CELLS = [w["name"] for w in cell.load_manifest()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cells_resolve_to_todays_functions(name, monkeypatch):
    c = cell.resolve(name)
    config, traffic = c["config"], c["traffic"]
    prog = cell.program_side(config["entry"])
    for hook in cell.PROGRAM_HOOKS:
        assert getattr(prog, hook) is getattr(program, hook), hook
    refs = cell.reference_side(config["entry"])
    assert refs.Reference is ReferenceModel
    assert refs.step_floor is bounds.step_floor
    assert refs.start_state is start.start_state
    # build_model makes the call into the port's driver that the benchmark made before
    import fenicsxfus_tpu_torch.drivers as drivers

    calls = []

    def record(fn, n):
        def inner(*a, **kw):
            calls.append((fn, a, kw))
            return ("model",) + (None,) * (n - 2) + (123,)
        return inner

    monkeypatch.setattr(drivers, "hitu", SimpleNamespace(build_model=record("box", 4),
                                                         build_bowl_model=record("bowl", 4)),
                        raising=False)
    monkeypatch.setattr(drivers, "ph1", SimpleNamespace(build_model=record("ph1", 5)),
                        raising=False)
    assert prog.build_model(config, traffic, "cpu") == ("model", 123)
    if config["entry"] == "hitu":
        want = (traffic["mesh"], (*config["variant"], config["nx"]),
                dict(degree=config["degree"], f0=config["f0"], cfl=traffic["cfl"],
                     dtype=torch.float32, device="cpu"))
    else:
        want = ("ph1", (config["sc"], traffic["bm"], config["nx"]),
                dict(dtype=torch.float32, cfl=traffic["cfl"], device="cpu"))
    assert calls == [want]


@pytest.mark.parametrize("name", ["no-such-entry", "../hitu", "", "reference"])
def test_unknown_entry_is_refused(name):
    for side in (cell.entry_files, cell.program_side, cell.reference_side):
        with pytest.raises(KeyError):
            side(name)


# ---- a toy entry: every lattice node an oscillator u'' = -(2 pi f0)^2 u

TOY_PROGRAM = '''
"""The toy entry's program side: RK4 on every node in the configuration's dtype."""
import math

import numpy as np
import torch

from fusbench.program import DTYPES


class Toy:
    degree = 1

    def __init__(self, config, device):
        self.nx, self.L = config["nx"], config["domain"]["L"]
        self.shape = (self.nx + 1, 3, 3)
        self.dt = 1.0 / config["f0"] / config["steps_a_period"]
        self.w2 = (2 * math.pi * config["f0"]) ** 2
        n = int(np.prod(self.shape))
        dtype = DTYPES[config["dtype"]]
        self.u, self.v = (torch.zeros(n, dtype=dtype, device=device) for _ in range(2))

    def march(self, t0, tf, points):
        axis = torch.as_tensor(np.rint(points[0] / self.L * self.nx).astype(np.int64) * 9 + 4)
        u, v, ys = self.u, self.v, []
        for _ in range(int(round((tf - t0) / self.dt))):
            k = [(v, -self.w2 * u)]
            for a in (0.5, 0.5, 1.0):
                k.append((v + a * self.dt * k[-1][1], -self.w2 * (u + a * self.dt * k[-1][0])))
            u = u + self.dt / 6 * (k[0][0] + 2 * k[1][0] + 2 * k[2][0] + k[3][0])
            v = v + self.dt / 6 * (k[0][1] + 2 * k[1][1] + 2 * k[2][1] + k[3][1])
            ys.append(u[axis])
        self.u, self.v = u, v
        return torch.stack(ys)


def build_model(config, traffic, device):
    return Toy(config, device), config["steps_a_period"]


def lattice_shape(model):
    return model.shape


def slab_cells(model):
    return 0


def set_state(model, u, v):
    model.u, model.v = u, v


def state(model):
    return model.u, model.v


def march_period(model, t0, tf, points):
    return model.march(t0, tf, points)


def wrap_plan(model, wrapper):
    pass


def wrap_band(model, wrapper):
    return False
'''

TOY_REFERENCE = '''
"""The toy entry's reference side: RK4's amplification matrix in float64."""
import math

import numpy as np
import torch


class Disc:
    def __init__(self, config, device):
        self.device, self.dtype = torch.device(device), torch.float64
        self.nx, self.L = config["nx"], config["domain"]["L"]
        self.gdims = (self.nx + 1, 3, 3)

    def locate(self, points):
        return np.rint(points[0] / self.L * self.nx).astype(np.int64) * 9 + 4


class Reference:
    def __init__(self, config, traffic, device, tf32=False):
        self.disc, self.geometry = Disc(config, device), {}
        self.spp = config["steps_a_period"]
        self.steps_per_s = config["f0"] * self.spp
        dt, w = 1.0 / self.steps_per_s, 2 * math.pi * config["f0"]
        z = dt * np.array([[0.0, 1.0], [-w * w, 0.0]])
        self.M = sum(np.linalg.matrix_power(z, j) / math.factorial(j) for j in range(5))

    def march(self, u, v, t0, tf, sensors):
        traces = []
        for _ in range(int(round((tf - t0) * self.steps_per_s))):
            u, v = self.M[0, 0] * u + self.M[0, 1] * v, self.M[1, 0] * u + self.M[1, 1] * v
            traces.append(u[torch.as_tensor(sensors)])
        return u, v, torch.stack(traces).cpu().numpy()


def step_floor(shape, degree, itemsize, slab_cells):
    nodes = int(np.prod(shape))
    return {"bound_ms": 4 * nodes * itemsize / 1e9 * 1e3, "bound_by": "toy bytes"}
'''

TOY_CONFIG = {"name": "toy", "source": "https://example.org/toy", "reduced": [],
              "entry": "toy", "dtype": "float32", "f0": 1000.0, "nx": 8,
              "steps_a_period": 40, "s0": 1500.0, "domain": {"L": 0.1, "W": 0.02},
              "sensors": {"count": 5, "axis_length": 0.1}}
TOY_TRAFFIC = {"name": "toy", "mesh": "box",
               "start": {"packets": 3, "amplitude_pa": 1.0, "width_m": [0.01, 0.03],
                         "k_over_k0": [0.5, 1.0]},
               "trace_periods": 2, "limits": {"trace_err": 1e-5, "state_err": 1e-5}}

TOY_RUN = '''
import json, sys, time
import torch
torch.set_num_threads(2)
from fusbench import cell, run, trace


def profile(fn, span_names=()):
    """The profiler stands in for the card's: 2 ms busy a traced period."""
    t0 = time.perf_counter()
    fn()
    return {"ops": [{"name": "toy", "start": 0, "dur": 4000, "spans": []}], "busy_s": 0.004,
            "gaps": [], "spans_found": [], "span_s": {}, "window_s": time.perf_counter() - t0}


trace.profile = profile
c = cell.resolve("toy")
outs = [run.run_cell(c, 2**31 + 11, 0.05, traced, "cpu") for traced in (False, True)]
print(json.dumps([run.finite(o) for o in outs]))
'''


def test_new_entry_is_new_files_alone(tmp_path):
    """A copy of the harness with a toy entry, configuration and traffic
    added as new files, and the toy cell in the manifest: ``run_cell`` runs
    it end to end and ``kernels_roofline`` divides the toy's own floor."""
    here = ROOT / "fusbench"
    shutil.copytree(here, tmp_path / "fusbench", ignore=shutil.ignore_patterns("__pycache__"))
    new = {"entries/toy.py": TOY_PROGRAM, "reference/entries/toy.py": TOY_REFERENCE,
           "configs/toy.json": json.dumps(TOY_CONFIG), "traffic/toy.json": json.dumps(TOY_TRAFFIC)}
    for rel, text in new.items():
        assert not (here / rel).exists()
        (tmp_path / "fusbench" / rel).write_text(textwrap.dedent(text))
    manifest = cell.load_manifest()
    manifest["configs"].append({"name": "toy", "source": TOY_CONFIG["source"],
                                "file": "fusbench/configs/toy.json", "reduced": [],
                                "why": "a toy"})
    manifest["workloads"].append({"name": "toy", "config": "toy", "traffic": "toy", "chips": 1,
                                  "why": "a toy"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in ("gdof_steps_per_s", "kernels_roofline"):
            m["workloads"].append("toy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    for res in (plain, traced):
        assert res["correct"], res["checks"]
        assert res["checks"]["trace_err"]["value"] < 1e-5
        assert res["info"]["floor_bound_by"] == "toy bytes"
    assert set(plain["metrics"]) == {"setup_s", "gdof_steps_per_s", "mem_peak_gib"}
    floor_ms = 4 * 9 * 9 * 4 / 1e9 * 1e3  # 81 nodes of float32
    busy_ms_per_step = 4.0 / (2 * 40)
    assert set(traced["metrics"]) == {"kernels_roofline"}
    assert traced["metrics"]["kernels_roofline"]["value"] == pytest.approx(
        100 * floor_ms / busy_ms_per_step)


def test_reference_imports_nothing_of_the_port():
    """The reference sides, and the reference they build, name no module of
    the port (or of the JAX package)."""
    for path in sorted((ROOT / "fusbench" / "reference").rglob("*.py")):
        assert "fenicsxfus_tpu" not in path.read_text(), path
