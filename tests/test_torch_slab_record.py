"""The port's slab decomposition, continued (see ``tests/test_torch_slab.py``):
sensor recording (the slab cases of ``tests/test_sharded_recording.py``),
the bowl-fitted mesh (``tests/test_hybrid.py:150-275``), the refusals, the
sharded example and the launcher. Each case runs in fp64 as the JAX
sharded solver on the suite's virtual devices, as the port in gloo ranks at
the same world size and as the port's model on one device, held at the JAX
tests' bounds (1e-11; 1e-10 for the implicit recording and the hybrid
implicit run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu as fus
from fenicsxfus_tpu.core.bowl import create_bowl_box as jbowl
from fenicsxfus_tpu.core.mesh import Mesh as JMesh
from fenicsxfus_tpu.parallel import slab as jslab
from fenicsxfus_tpu_torch.examples import sharded_planewave3d
from fenicsxfus_tpu_torch.parallel import runs, spawn

torch.set_num_threads(1)

BOX = ("box", (9, 3, 3), (0.0, 0.0, 0.0), (1.0, 0.4, 0.4))
DT_W = 0.4 / 9 / 1.5 / 9
W_ARGS = (3, 1.5, 1.0, 4e-3, 3.5, 10.0, 1.0, 1.5, 4, DT_W)
AXIAL7 = np.stack([np.linspace(0.05, 0.95, 7), np.full(7, 0.2), np.full(7, 0.2)])
_r = np.random.default_rng(5)
OFF_AXIS = np.stack([_r.uniform(0.05, 0.95, 9), _r.uniform(0.05, 0.35, 9),
                     _r.uniform(0.05, 0.35, 9)])
DT_IMP = 0.4 / 8 / 1.5
AXIAL5 = np.stack([np.linspace(0.05, 0.95, 5), np.full(5, 0.2), np.full(5, 0.2)])

# the bowl whose blend band fits inside rank 0's slab at 4 ranks
SHALLOW = ("bowl", ((16, 7, 7), (0, 0, 0), (1.0, 0.9, 0.9), 0.9, 0.25),
           {"blend": 0.08, "lateral_hold": 0.08})
_H_MIN = runs.make_mesh({"mesh": SHALLOW}).h_min()
F0_BOWL = 1.0 / 0.3
DT_BOWL, DT_BOWL_IMP = 0.3 * _H_MIN / 9, 0.6 * _H_MIN / 9
_r = np.random.default_rng(5)
C0_BOWL, RHO_BOWL = _r.uniform(0.9, 1.1, 784), _r.uniform(0.9, 1.1, 784)
XS = np.linspace(0.4, 0.9, 4)
BEYOND_BAND = np.stack([XS, np.full(4, 0.45), np.full(4, 0.45)])


def _spec(name, mesh, model, args, run, t_end, tag_L=1.0, **extra):
    return dict(name=name, mesh=mesh, tag_L=tag_L, model=model, args=args, dtype="float64",
                run=run, t_end=t_end, **extra)


CASES = {  # name: (world, spec)
    "rk_record": (2, _spec("rk_record", BOX, "WesterveltSpectralExplicit", W_ARGS,
                           "rk_record", 40 * DT_W, points=AXIAL7)),
    "off_axis": (4, _spec("off_axis", BOX, "WesterveltSpectralExplicit", W_ARGS, "rk_record",
                          25 * DT_W, points=OFF_AXIS)),
    "dirk_record": (4, _spec("dirk_record", ("box", (8, 3, 3), (0, 0, 0), (1.0, 0.4, 0.4)),
                             "LinearSpectralImplicit", (2, 1.5, 1.0, 10.0, 1.0, 1.5, 2, DT_IMP),
                             "dirk_record", 6 * DT_IMP, points=AXIAL5,
                             kwargs={"cg_rtol": 1e-12})),
    "nonzero_state": (2, _spec("nonzero_state", ("box", (8, 2, 2), (0, 0, 0), (1.0, 0.4, 0.4)),
                               "LinearSpectralExplicit",
                               (3, 1.5, 1.0, 10.0, 1.0, 1.5, 4, 1e-3), "streamed_nonzero",
                               2e-3)),
    "deformed": (2, _spec("deformed", ("deformed", (6, 4, 4), (0, 0, 0), (1.0, 0.9, 0.9), 2,
                                       0.02), "LinearSpectralExplicit", (3,), "decompose", None)),
    # blend_layers > 3 = the slab of each of 2 ranks: the band spans both
    "wide_band": (2, _spec("wide_band", ("bowl", ((6, 6, 6), (0, 0, 0), (1.0, 0.9, 0.9), 0.7,
                                                  0.35), {}),
                           "LinearSpectralExplicit", (3,), "decompose", None)),
    "hybrid_linear": (4, _spec("hybrid_linear", SHALLOW, "LinearSpectralExplicit",
                               (3, C0_BOWL, RHO_BOWL, F0_BOWL, 1.0, 1.0, 4, DT_BOWL), "rk",
                               20 * DT_BOWL, tag_L=None)),
    "hybrid_westervelt": (4, _spec("hybrid_westervelt", SHALLOW, "WesterveltSpectralExplicit",
                                   (3, C0_BOWL, RHO_BOWL, 4e-3, 3.5, F0_BOWL, 1.0, 1.0, 4,
                                    DT_BOWL), "rk", 20 * DT_BOWL, tag_L=None)),
    "hybrid_record": (4, _spec("hybrid_record", SHALLOW, "LinearSpectralExplicit",
                               (3, 1.0, 1.0, F0_BOWL, 1.0, 1.0, 4, DT_BOWL), "rk_record",
                               15 * DT_BOWL, tag_L=None, points=BEYOND_BAND,
                               bad_points=np.array([[0.02], [0.45], [0.45]]))),
    "hybrid_implicit": (4, _spec("hybrid_implicit", SHALLOW, "LinearSpectralImplicit",
                                 (3, 1.0, 1.0, F0_BOWL, 1.0, 1.0, 2, DT_BOWL_IMP), "dirk",
                                 10 * DT_BOWL_IMP, tag_L=None)),
}


@pytest.fixture(scope="module")
def port():
    """Every case's port run on every rank: {name: [rank 0's result, ...]};
    one gloo launch per world size."""
    out = {}
    for world in sorted({w for w, _ in CASES.values()}):
        names = [n for n, (w, _) in CASES.items() if w == world]
        per_rank = spawn(runs.run_cases, world, "gloo", "cpu",
                         args=([CASES[n][1] for n in names],))
        for i, name in enumerate(names):
            out[name] = [r[i] for r in per_rank]
    return out


def jax_mesh(spec):
    kind, *rest = spec["mesh"]
    if kind == "bowl":
        return jbowl(*rest[0], **rest[1])[0]
    if kind == "deformed":
        pm = runs.make_mesh(spec)  # the same seeded vertices
        return JMesh(dim=pm.dim, vertices=pm.vertices, cells=pm.cells, grid_shape=pm.grid_shape)
    n, lo, hi = rest
    return fus.tag_boundaries(fus.create_box(n, lo, hi),
                              {1: lambda x: x[0] < 1e-12, 2: lambda x: x[0] > 1.0 - 1e-12})


def jax_solver(spec, ndev):
    m = getattr(fus, spec["model"])(jax_mesh(spec), None, *spec["args"], dtype=jnp.float64,
                                    **spec.get("kwargs", {}))
    m.init()
    cls = jslab.ShardedImplicitSolver if spec["run"].startswith("dirk") else \
        jslab.ShardedExplicitSolver
    return m, cls(m, ndev=ndev)


def rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(np.max(np.abs(b)), 1e-300))


def held(port, name, tol=1e-11, keys=("u", "v")):
    """The port at world size n against the JAX sharded solver at ndev = n
    and the port's single device, on ``keys``; every rank holds the same
    global fields and series."""
    world, spec = CASES[name]
    got = port[name][0]
    for other in port[name][1:]:
        for key in keys:
            assert np.array_equal(other[key], got[key]), (name, key)
    jm, js = jax_solver(spec, world)
    march = getattr(js, spec["run"])
    if spec["run"].endswith("_record"):
        u, v, _, times, ys = march(0.0, spec["t_end"], spec["points"])
        ref = {"u": u, "v": v, "ys": ys, "times": times}
        np.testing.assert_allclose(got["times"], times, rtol=0, atol=1e-14)
        # the nearest lattice node of each sensor: (holding rank, local coordinates)
        for a, b in zip(got["located"], js.dec.locate_sensors(spec["points"])):
            np.testing.assert_array_equal(a, b)
    else:
        u, v, _ = march(0.0, spec["t_end"])
        ref = {"u": u, "v": v}
    single = runs.run_single(spec, torch.device("cpu"))
    for key in keys:
        assert rel(got[key], ref[key]) < tol, (name, key, "jax", rel(got[key], ref[key]))
        assert rel(got[key], single[key]) < tol, (name, key, "single",
                                                  rel(got[key], single[key]))
    return got, jm, js, single


def test_slab_rk_record(port):
    """9 cells on 2 ranks (an uneven partition), axial sensors off the nodes."""
    held(port, "rk_record", keys=("u", "v", "ys"))


def test_slab_record_off_axis_sensors(port):
    """Sensors scattered across ranks and lateral positions: each rank's
    slots and the host reassembly."""
    held(port, "off_axis", keys=("u", "ys"))


def test_slab_dirk_record(port):
    """The implicit recording, with the CG counts and residuals it surfaces."""
    got, jm, _, single = held(port, "dirk_record", tol=1e-10, keys=("u", "ys"))
    assert got["cg"] > 0 and got["cg_res2"] < 1e-10
    assert abs(got["cg"] - jm.cg_stats["max_iterations"]) <= 2
    assert abs(got["cg"] - single["cg"]) <= 2


def test_streamed_rejects_nonzero_initial_state(port):
    """The streamed setup starts from zero fields: a nonzero template state
    raises on every rank, as in the JAX package."""
    for r in port["nonzero_state"]:
        assert r["error"] is not None and "zero fields" in r["error"]


def test_sharding_rejects_deformed_mesh(port):
    """A generally deformed lattice is refused; a bowl whose blend band
    spans more than rank 0's slab is refused too (the JAX package refuses
    both, with the same words)."""
    for name, word in (("deformed", "deformed"), ("wide_band", "blend")):
        spec = CASES[name][1]
        for r in port[name]:
            assert r["error"] is not None and word in r["error"], (name, r["error"])
        with pytest.raises(ValueError, match=word):
            jslab.SlabDecomposition(jax_mesh(spec), 3, 2, jnp.float64)


@pytest.mark.parametrize("kind", ["linear", "westervelt"])
def test_hybrid_sharded_slab_matches_single_device(port, kind):
    """The bowl shards through the lattice path: K1 on every rank, the band
    correction on rank 0 only, across the band/uniform seam."""
    held(port, f"hybrid_{kind}")


def test_hybrid_sharded_recording(port):
    """Sensors beyond the band record the single device's series; a sensor
    in the band is refused."""
    got, *_ = held(port, "hybrid_record", keys=("u", "ys"))
    for r in port["hybrid_record"]:
        assert r["bad_points_error"] is not None and "blend band" in r["bad_points_error"]


def test_hybrid_sharded_implicit_matches_single_device(port):
    """The SDIRK path on the bowl: the CG's stiffness carries rank 0's band
    correction; the Jacobi diagonal, assembled globally, slices per slab."""
    held(port, "hybrid_implicit", tol=1e-10, keys=("u",))


def test_sharded_example_matches_jax(monkeypatch, capsys):
    """The sharded example at 2 gloo ranks against the JAX script on 2
    virtual devices, both fp32 as the script runs: the same rank count and
    DOFs, u within 1e-5 of its maximum (the two packages sum in other
    orders; fp32 epsilon 1.2e-7 over 48 RK4 steps)."""
    from examples import sharded_planewave3d as jexample

    got = sharded_planewave3d.main(nx=16, degree=3, world=2, backend="gloo", device="cpu")
    seen = {}
    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:2])
    rk = jslab.ShardedExplicitSolver.rk

    def recording_rk(self, t0, tf):
        seen["u"], *_ = out = rk(self, t0, tf)
        return out

    monkeypatch.setattr(jslab.ShardedExplicitSolver, "rk", recording_rk)
    capsys.readouterr()
    jexample.main(nx=16, degree=3)
    printed = capsys.readouterr().out
    assert f"2 devices, {got['ndofs']} DOFs" in printed and got["ndev"] == 2
    assert got["u"].dtype == np.float32 and np.asarray(seen["u"]).dtype == np.float32
    assert rel(got["u"], seen["u"]) < 1e-5, rel(got["u"], seen["u"])
    assert abs(got["max_u"] - float(printed.split("= ")[-1])) <= 0.05 + 1e-5 * got["max_u"]


def test_spawn_fails_with_the_ranks_traceback():
    """A rank that raises fails the launch with its traceback (the other
    ranks are ended, nothing hangs)."""
    bad = dict(CASES["deformed"][1], mesh=("nowhere",), run="rk", t_end=1.0)
    with pytest.raises(RuntimeError, match="unknown mesh kind 'nowhere'"):
        spawn(runs.run_cases, 2, "gloo", "cpu", args=([bad],), timeout=120)
