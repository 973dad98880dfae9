"""The port's attribution scripts (``fenicsxfus_tpu_torch/tools/
{setup_speed,phase_breakdown,wave_attrib,unstructured_speed,
unstructured_trace}.py``) against the JAX package's scripts
(``benchmarks/*.py``) at tiny sizes on the CPU, in fp64: what each computes
equals what the JAX script (or, where it reaches the TPU-only
``ops.pallas2``, the JAX package's model and operators) computes, and no
time is given on the CPU. Their times are the card's (``chip_smoke.py``
[19]).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu.ops.operators as jops_mod
from fenicsxfus_tpu.core.mesh import Mesh as JaxMesh
from fenicsxfus_tpu.models.common import make_rk_step
from fenicsxfus_tpu_torch.tools import (
    phase_breakdown, setup_speed, unstructured_speed, unstructured_trace, wave_attrib,
)

torch.set_num_threads(1)

TOL = 1e-12


def rel(a, b) -> float:
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_setup_speed_matches_jax(capsys):
    """The phases are the JAX script's (and the port's upload), and the
    mass, facet and coefficient vectors are the JAX package's (1e-12)."""
    importlib.import_module("benchmarks.setup_speed").main(nx=3, degree=2)
    jax_names = [line.split(":")[0].strip() for line in capsys.readouterr().out.splitlines()
                 if line.startswith("  ") and "TOTAL" not in line]
    res = setup_speed.main(nx=3, degree=2, dtype=torch.float64, device="cpu")
    assert [name for name, _ in res["rows"]] == jax_names + ["upload"]
    assert all(s >= 0 for _, s in res["rows"]) and res["ndofs"] == 7**3
    from fenicsxfus_tpu import create_box, tag_boundaries

    mesh = create_box((3, 3, 3), (0, 0, 0), (0.12,) * 3)
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > 0.12 - 1e-9})
    jops = jops_mod.SEMOperators(mesh, 2, dtype=jnp.float64)
    vec = res["vectors"]
    for name, ref in (("mass", jops.assemble_diag(1.0)), ("src", jops.facet_vector(1, 1.0)),
                      ("abc", jops.facet_vector(2, 1.0))):
        assert vec[name].dtype == torch.float64 and rel(vec[name], ref) <= TOL, name
    # the coefficient through the same apply on both sides
    x = np.random.default_rng(3).standard_normal(res["ndofs"])
    from fenicsxfus_tpu_torch.ops.operators import SEMOperators

    tmesh = importlib.import_module("fenicsxfus_tpu_torch").create_box((3, 3, 3), (0, 0, 0),
                                                                       (0.12,) * 3)
    tops = SEMOperators(tmesh, 2, dtype=torch.float64, device="cpu")
    y = tops.stiffness_apply([torch.as_tensor(x)], [vec["coeff"]])
    jy = jops.stiffness_apply([jnp.asarray(x)], [jops.stiff_coeff(1.0)])
    assert rel(y, jy) <= TOL


def _jax_model(kind, nx=3):
    from fenicsxfus_tpu import (
        LinearSpectralExplicit, LossySpectralExplicit, WesterveltSpectralExplicit,
        create_box, tag_boundaries,
    )

    cls = {"linear": LinearSpectralExplicit, "lossy": LossySpectralExplicit,
           "westervelt": WesterveltSpectralExplicit}[kind]
    extra = phase_breakdown.KINDS[kind][1]
    L, c0 = 0.12, 1500.0
    mesh = create_box((nx, nx, nx), (0, 0, 0), (L, L, L))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9, 2: lambda x: x[0] > L - 1e-9})
    dt = 0.9 * (L / nx) / (c0 * 16)
    m = cls(mesh, None, 4, c0, 1000.0, *extra, 0.5e6, 60000.0, c0, 4, dt, dtype=jnp.float64)
    m.init()
    return m


@pytest.mark.parametrize("kind", ["linear", "lossy", "westervelt"])
def test_phase_and_wave_steps_match_jax(kind):
    """From the same random state and t: 3 steps through the unfused step,
    the plain K2 step and the plain K3 step (``wave_attrib.paths``) agree
    with each other and with the JAX model's ``rhs_pure`` steps (1e-12);
    ``phase_breakdown.measure`` gives its rows without times and holds
    fused against unfused."""
    model = phase_breakdown.build(3, kind, torch.float64, "cpu")
    jm = _jax_model(kind)
    rng = np.random.default_rng(1)
    u0, v0 = (rng.standard_normal(model.number_of_dofs()) for _ in range(2))
    model.u_n, model.v_n, model.t = torch.as_tensor(u0), torch.as_tensor(v0), 2e-6
    got = wave_attrib.paths(model, 3)
    step = make_rk_step(lambda c, t, u, v: type(jm).rhs_pure(jm.ops, c, t, u, v), 4)
    carry = (jnp.asarray(u0), jnp.asarray(v0), 2e-6)
    for _ in range(3):
        carry, _ = step(jm.consts, carry, jm.dt)
    for name, (u, v) in got.items():
        assert rel(u, carry[0]) <= TOL and rel(v, carry[1]) <= TOL, name
    res = phase_breakdown.measure(model, nsteps=2)
    assert res["step_kind"] == "fused" and res["held"] <= TOL
    assert set(res["rows"]) == {"step", "stage", "stiffness", "pointwise", "unfused"}
    assert all(r["ms"] is None and r["share"] is None for r in res["rows"].values())
    assert res["rows"]["stiffness"]["bound_ms"] > 0 and res["rows"]["step"]["bound_ms"] > 0


def test_wave_attrib_rows_on_the_cpu():
    res = wave_attrib.main(nx=3, chain=2, dtype=torch.float64, device="cpu")
    assert res["sep"] and res["plan"]["ring_planes"] > 0 and res["k3_vs_k2"] <= TOL
    assert list(res["rows"]) == ["K3 chained", "real rk", "real loop", "four K2"]
    assert all(r["ms"] is None for r in res["rows"].values())


def _jax_script_mesh(monkeypatch, nx, shuffle, reorder):
    """The mesh the JAX ``unstructured_speed.py`` builds (its main stopped
    at its first ``SEMOperators``)."""
    seen = []

    class Stop(Exception):
        pass

    def record(mesh, *a, **k):
        seen.append(mesh)
        raise Stop

    monkeypatch.setattr(jops_mod, "SEMOperators", record)
    with pytest.raises(Stop):
        importlib.import_module("benchmarks.unstructured_speed").main(
            nx=nx, shuffle=shuffle, reorder=reorder)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("reorder", [False, True])
def test_unstructured_speed_matches_jax(monkeypatch, reorder):
    """On the shuffled box, and the same after ``reorder_locality``: the
    mesh and ``build_csr_plan`` equal the JAX script's; CSR = fold =
    segment sum, the two cell routes and the apply against the oracle
    (1e-12); the apply equals the JAX package's ``stiffness_apply``."""
    jmesh = _jax_script_mesh(monkeypatch, 3, True, reorder)
    mesh = unstructured_speed.distorted_box(3, shuffle=True, reorder=reorder)
    assert np.array_equal(mesh.cells, jmesh.cells) and np.array_equal(mesh.vertices,
                                                                        jmesh.vertices)
    from fenicsxfus_tpu_torch.ops.operators import SEMOperators

    ops = SEMOperators(mesh, 4, dtype=torch.float64, device="cpu")
    jops = jops_mod.SEMOperators(JaxMesh(dim=3, vertices=jmesh.vertices, cells=jmesh.cells), 4,
                                 dtype=jnp.float64)
    jcsr = importlib.import_module("benchmarks.unstructured_speed").build_csr_plan
    for a, b in zip(unstructured_speed.build_csr_plan(ops.space.dofmap, ops.ndofs),
                    jcsr(np.asarray(jops.space.dofmap), jops.ndofs)):
        assert np.array_equal(a, b)
    res = unstructured_speed.main(nx=3, with_segsum=True, shuffle=True, reorder=reorder,
                                  dtype=torch.float64, device="cpu")
    assert all(v <= TOL for v in res["held"].values()), res["held"]
    assert res["ratio"] is None and all(r["ms"] is None for r in res["rows"].values())
    assert {"gather", "contract", "sum-factorised", "dense", "fold", "apply", "lattice",
            "segment sum", "csr fold", "apply (oracle)"} == set(res["rows"])
    rng = np.random.default_rng(5)
    x, coeff = rng.standard_normal(ops.ndofs), 0.5 + rng.random(mesh.num_cells)
    y = ops.stiffness_apply([torch.as_tensor(x)], [ops.stiff_coeff(coeff)])
    jy = jops.stiffness_apply([jnp.asarray(x)], [jnp.asarray(coeff)])
    assert rel(y, jy) <= TOL


def test_unstructured_trace_matches_jax():
    """The three windows of the trace script from the JAX script's model
    and mesh (``benchmarks/unstructured_solve.py::distorted_box``): the
    same state (1e-10)."""
    from fenicsxfus_tpu import LinearSpectralExplicit

    nx, steps = 2, 3
    res = unstructured_trace.main(nx=nx, steps=steps, dtype=torch.float64, device="cpu")
    assert res["step_kind"] == "unfused" and res["wall_s"] is None and res["ops"] == []
    mesh = importlib.import_module("benchmarks.unstructured_solve").distorted_box(nx, 4)
    dt = 0.4 * mesh.h_min() / (1.5 * 16)
    jm = LinearSpectralExplicit(mesh, None, 4, 1.5, 1.0, 10.0, 1.0, 1.5, 4, dt,
                                dtype=jnp.float64)
    jm.init()
    jm._build()
    u, v = jm.u_n, jm.v_n
    for _ in range(3):
        u, v, _t = jm._solve(jm.consts, u, v, 0.0, steps * dt, dt)
    assert float(jnp.max(jnp.abs(u))) > 0 and rel(res["u"], u) <= 1e-10
