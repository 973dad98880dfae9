"""The plain reference against the port's plain CPU path at a tiny size, in
float64: the run's own comparison (``run_cell`` on the CPU, where every
kernel of the port runs its plain twin) reads rounding only, in every cell."""

import numpy as np
import pytest
import torch

from fusbench import cell, run
from fusbench.reference import sem
from fusbench.reference.model import ReferenceModel

CELLS = [w["name"] for w in cell.load_manifest()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name, tiny):
    torch.set_num_threads(2)
    c = tiny(name, nx=16 if c_is_bowl(name) else 8)
    c["config"]["dtype"] = "float64"
    out = run.run_cell(c, 2**31 + 7, 0.5, False, "cpu")
    ch = out["checks"]
    assert ch["trace_err"]["value"] < 1e-12 and ch["state_err"]["value"] < 1e-12, ch
    assert ch["nonfinite"]["value"] == 0 and ch["steps_a_period_gap"]["value"] == 0
    assert out["correct"]


def c_is_bowl(name):
    return cell.resolve(name)["traffic"]["mesh"] == "bowl"


def test_gll_rule_and_derivative():
    x, w = sem.gll(5)
    assert abs(w.sum() - 1.0) < 1e-15 and x[0] == 0.0 and x[-1] == 1.0
    D = sem.diff_matrix(x)
    # exact on polynomials of degree N - 1
    assert np.allclose(D @ x**4, 4 * x**3, atol=1e-12)
    # the rule integrates degree 2N - 3 exactly
    assert abs(w @ x**7 - 1 / 8) < 1e-15


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-12, 3.0], dtype=torch.float32)
    y = sem.to_tf32(x)
    assert y.tolist() == [1.0 + 2.0**-10, 1.0, 3.0]


def test_locate_on_the_bowl_mesh(tiny):
    c = tiny("h101-bowl", nx=16)
    ref = ReferenceModel(c["config"], c["traffic"], "cpu")
    pts = run.axial_points(c["config"])
    rows, wts = ref.disc.locate(pts)
    assert np.allclose(wts.sum(axis=1), 1.0)
    # the interpolated node coordinates give the points back
    X = np.zeros((ref.disc.ndofs, 3))
    for cidx in range(ref.disc.nc):
        val, _ = sem.q1_shape(sem.tensor_points(ref.disc.x1))
        X[ref.disc.dofmap_np[cidx]] = val @ ref.disc.cell_verts[cidx]
    assert np.allclose(np.einsum("nk,nka->na", wts, X[rows]), pts.T, atol=1e-9)
