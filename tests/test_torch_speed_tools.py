"""The port's speed and attribution tools (``fenicsxfus_tpu_torch/tools/
{operator_speed,stage_attrib,solver_speed,hybrid_speed}.py``) at tiny sizes
on the CPU, where every kernel wrapper runs its plain version and nothing is
timed: the rows have the right shape, each kernel path equals its plain
version, every bound comes from the row's own inputs, and no time is given
for the card. Their times are the card's (``chip_smoke.py`` [18]). Also the
scripts' shared command line (``fenicsxfus_tpu_torch/scripts.py``).
"""

import sys

import numpy as np
import pytest
import torch

from fenicsxfus_tpu_torch import scripts
from fenicsxfus_tpu_torch.tools import bounds, hybrid_speed, operator_speed, solver_speed
from fenicsxfus_tpu_torch.tools import stage_attrib

torch.set_num_threads(1)


@pytest.mark.parametrize("fus_v3,pipeline", [("1", "K1"), ("0", "K4a+K4b")])
def test_operator_speed_rows(monkeypatch, fus_v3, pipeline):
    monkeypatch.setenv("FUS_V3", fus_v3)
    rows = operator_speed.main(dofs=3e3, degrees=(2, 3, 5), device="cpu")
    assert len(rows) == 9
    for r in rows:
        p = r["degree"]
        nx = int(round(3e3 ** (1 / 3) / p))
        assert r["gdims"] == (nx * p + 1,) * 3 and r["ndofs"] == (nx * p + 1) ** 3
        assert r["ms"] is None and r["device_ms"] is None and r["share"] is None
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
    stiff = [r for r in rows if r["op"].startswith("stiffness")]
    assert [r["op"] for r in stiff[:2]] == ["stiffness const", "stiffness DG-0"]
    assert all(r["pipeline"] == pipeline and r["rel"] <= 1e-12 for r in stiff)
    # the constant row's bound: x read and y written once (and the small
    # packed coefficient), or the stencil's operations
    r, n = stiff[0], stiff[0]["ndofs"]
    floor = max(8 * n / bounds.HBM_BYTES_PER_S * 1e3,
                bounds.stencil_flops(r["gdims"], r["degree"], 1, (0, 1, 2))
                / bounds.FP32_FLOP_PER_S * 1e3)
    assert floor <= r["bound_ms"] <= 1.2 * floor


def test_operator_speed_setup_sizes():
    """At the default 38.3M DOF the lattices are G = 339, 337, 337, 336, 337
    nodes a side for p = 2..6 (computed, not built)."""
    gs = [max(int(round(38.3e6 ** (1 / 3) / p)), 2) * p + 1 for p in (2, 3, 4, 5, 6)]
    assert gs == [339, 337, 337, 336, 337]


def test_stage_attrib_rows():
    res = stage_attrib.main(nx=3, device="cpu")
    rows = res["rows"]
    assert [r["slopes"] for r in rows] == [0, 1, 2]
    assert all(r["rel"] == 0.0 and r["ms"] is None for r in rows)
    # one more field read each: the bound grows by one field's bytes
    field_ms = res["ndofs"] * 4 / bounds.HBM_BYTES_PER_S * 1e3
    assert rows[0]["bound_by"] == "bytes"
    assert np.isclose(rows[1]["bound_ms"] - rows[0]["bound_ms"], field_ms)
    assert np.isclose(rows[2]["bound_ms"] - rows[1]["bound_ms"], field_ms)
    assert "marginal_ms" not in res


@pytest.mark.parametrize("model", ["linear", "lossy", "westervelt"])
def test_solver_speed_rows(model):
    res = solver_speed.main(nx=3, steps=2, model=model, device="cpu")
    assert res["step_kind"] == "fused" and res["ndofs"] == 13**3
    assert res["seconds"] is None and res["rate"] is None and res["bound_ms_step"] > 0
    assert bool(torch.isfinite(res["u"]).all()) and float(res["u"].abs().max()) > 0
    assert res["model"] == model and res["eqn"].u_n is res["u"] and res["eqn"].t == res["t"]


def test_solver_speed_step_bound_is_four_stages():
    eqn, _ = solver_speed.build(3, "lossy", "cpu")
    u0 = eqn.u_n.clone()
    b = solver_speed.step_bound_ms(eqn)
    assert torch.equal(eqn.u_n, u0)  # the probe step leaves the state
    nf_bytes = eqn.u_n.numel() * 4
    assert b > 4 * 5 * nf_bytes / bounds.HBM_BYTES_PER_S * 1e3


def test_hybrid_speed_rows():
    res = hybrid_speed.main(nx=10, degree=2, device="cpu")
    assert set(res["paths"]) == {"lattice", "hybrid", "band"}
    assert all(r["ms"] is None and r["bound_ms"] > 0 for r in res["paths"].values())
    assert res["paths"]["hybrid"]["bound_ms"] > res["paths"]["lattice"]["bound_ms"]
    assert res["rel"] <= 1e-12 and res["slab_cells"] > 0


def test_scripts_cli(monkeypatch):
    def main(epw=4, degree=4, hetero=False, window="heaviside", ka=1.5, out=None, dtype=None,
             device="cuda"):
        return dict(locals())

    monkeypatch.setattr(sys, "argv", ["x", "--epw", "2", "--hetero", "--ka", "0.5",
                                      "--dtype", "float64", "--device", "cpu", "--out", "o"])
    res = scripts.cli(main, "test")
    assert res == dict(epw=2, degree=4, hetero=True, window="heaviside", ka=0.5, out="o",
                       dtype=torch.float64, device="cpu")
    assert scripts.device_dtype("cpu") == (torch.device("cpu"), torch.float64)
    assert scripts.device_dtype("cpu", cpu_dtype=torch.float32)[1] == torch.float32
    assert scripts.device_dtype("cpu", torch.float32)[1] == torch.float32
