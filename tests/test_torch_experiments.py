"""The port's experiments (``fenicsxfus_tpu_torch/experiments/``) and
MENDOUSSE (``fenicsxfus_tpu_torch/drivers/mendousse.py``) against the JAX
package's scripts (``experiments/exp1-5``, ``benchmarks/mendousse.py``), both
in fp64, the port on the CPU. Each JAX script's model marches and error
norms are recorded through wrappers set here; final fields agree to 1e-9
(relative max-norm), the printed errors (L2, H1, the MENDOUSSE table) to
1e-9, exp4's observed orders to 1e-6. exp1-exp4 run whole. exp5 and
MENDOUSSE ``--quick`` take 28 s and 21 s on one thread, so their tier-1 cases
march the same problems over a shorter horizon (every JAX ``rk`` call's span
scaled by the port's ``depth``), and the whole scripts are ``slow`` cases.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsxfus_tpu
from fenicsxfus_tpu.analysis import error as jerror
from fenicsxfus_tpu.analysis.analytical import mendousse
from fenicsxfus_tpu.models import base as jbase

torch.set_num_threads(1)

TOL = 1e-9
ROUND = 2e-15  # about ten fp64 roundings of a relative norm of order 1


def rel(a, b) -> float:
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def close(a, b, tol=TOL) -> bool:
    return abs(a - b) <= tol * max(abs(b), 1e-300)


@pytest.fixture
def jax(monkeypatch):
    """Records of the JAX scripts' calls: ``rk`` results as (model, (u, v,
    t)), and the values of ``relative_l2_error``, ``relative_h1_error`` and
    ``eval_function``. ``rk`` marches ``depth`` of each span it is given
    (set ``rec["depth"]``)."""
    rec = {"depth": 1.0, "rk": [], "l2": [], "h1": [], "eval": []}
    rk = jbase.ExplicitModelBase.rk

    def scaled_rk(self, t0, tf):
        out = rk(self, t0, t0 + rec["depth"] * (tf - t0))
        rec["rk"].append((self, out))
        return out

    def recorder(module, name, key):
        orig = getattr(module, name)

        def f(*args, **kwargs):
            out = orig(*args, **kwargs)
            rec[key].append(out)
            return out

        monkeypatch.setattr(module, name, f)

    monkeypatch.setattr(jbase.ExplicitModelBase, "rk", scaled_rk)
    recorder(jerror, "relative_l2_error", "l2")
    recorder(jerror, "relative_h1_error", "h1")
    recorder(fenicsxfus_tpu, "eval_function", "eval")
    return rec


def both(jax, package, name, depth=1.0, **kwargs):
    jax["depth"] = depth
    importlib.import_module(f"{package}.{name}").main(**kwargs)
    port = importlib.import_module(f"fenicsxfus_tpu_torch.{package}.{name}").main(
        depth=depth, device="cpu", **kwargs)
    return port


def test_exp1_matches_jax(jax):
    port = both(jax, "experiments", "exp1_windowing")
    labels = ["4-period ramp", "~no window"]
    assert [m.alpha for m, _ in jax["rk"]] == [4.0, 0.02]
    for label, (_, (u, _, t)), err in zip(labels, jax["rk"], jax["l2"]):
        assert rel(port["u"][label], u) <= TOL and close(port["errors"][label], float(err))
    assert close(port["t"], jax["rk"][-1][1][2])
    assert port["errors"]["4-period ramp"] < 1e-3 < port["errors"]["~no window"]


def test_exp2_matches_jax(jax):
    port = both(jax, "experiments", "exp2_p_convergence")
    assert [r[0] for r in port["rows"]] == [2, 3, 4, 5, 6]
    for (p, l2, h1), (_, (u, _, _)), jl2, jh1 in zip(port["rows"], jax["rk"], jax["l2"],
                                                     jax["h1"]):
        assert rel(port["u"][p], u) <= TOL
        assert close(l2, float(jl2)) and close(h1, float(jh1))
    # the line's points sit near nodes of the plane wave: values ~1e-6 of p0,
    # held to 1e-9 of the field's scale
    d = np.abs(port["eval_line"] - jax["eval"][-1][1]).max()
    assert d <= TOL * float(jnp.max(jnp.abs(jax["rk"][-1][1][0])))
    l2s = [r[1] for r in port["rows"]]
    assert all(a > b for a, b in zip(l2s, l2s[1:]))  # p-convergence


def test_exp3_matches_jax(jax):
    port = both(jax, "experiments", "exp3_source_conformity")
    for label, (_, (u, _, _)) in zip(port["u"], jax["rk"]):
        assert rel(port["u"][label], u) <= TOL
        assert close(port["max_u"][label], float(jnp.max(jnp.abs(u))))


def test_exp4_matches_jax(jax):
    port = both(jax, "experiments", "exp4_rk_order")
    (_, (u_ref, _, _)), runs = jax["rk"][0], jax["rk"][1:]
    assert rel(port["u_ref"], u_ref) <= TOL and len(runs) == 12
    for i, order in enumerate([1, 2, 3, 4]):
        errs = [float(jnp.linalg.norm(u - u_ref) / jnp.linalg.norm(u_ref))
                for _, (u, _, _) in runs[3 * i:3 * i + 3]]
        rates = [np.log2(errs[k] / errs[k + 1]) for k in range(2)]
        # the errors are norms of differences of fields that agree to fp64
        # roundoff: equal to 1e-9 or within ROUND of each other
        assert all(abs(a - b) <= max(TOL * b, ROUND)
                   for a, b in zip(port["errors"][order], errs))
        # the orders to 1e-6, or to what a ROUND change of each error can
        # move them where that is more (RK4's finest errors are 3.4e-10)
        for k in range(2):
            tol = max(1e-6, ROUND * (1 / errs[k] + 1 / errs[k + 1]) / np.log(2))
            assert abs(port["rates"][order][k] - rates[k]) <= tol
    assert [round(r) for r in port["rates"][4]] == [4, 4]


def _exp5(jax, depth):
    port = both(jax, "experiments", "exp5_delta_stiffness", depth=depth)
    assert len(port["runs"]) == len(jax["rk"])
    dt0 = 0.9 * (1.0 / 41) / 16
    for (_, frac, u), (m, (ju, _, _)) in zip(port["runs"], jax["rk"]):
        assert close(m.dt, frac * dt0)
        fin = bool(jnp.all(jnp.isfinite(ju)))
        assert fin == bool(torch.isfinite(u).all())
        if fin:
            assert rel(u, ju) <= TOL
    return port


def test_exp5_matches_jax_over_a_quarter_horizon(jax):
    _exp5(jax, 0.25)


@pytest.mark.slow
def test_exp5_matches_jax(jax):
    port = _exp5(jax, 1.0)
    assert port["stable"] == {0.0: 1.0, 2e-3: 1.0, 2e-2: 0.25, 8e-2: 0.0625}


def _mendousse(jax, depth):
    jax["depth"] = depth
    importlib.import_module("benchmarks.mendousse").main(quick=True)
    from fenicsxfus_tpu_torch.drivers import mendousse as pm

    port = pm.main(quick=True, depth=depth, device="cpu")
    jm, (u, _, tf) = jax["rk"][-1]
    delta0 = fenicsxfus_tpu.compute_diffusivity_of_sound(2 * np.pi * 1e6, 1500.0, 25.0)
    assert rel(port["u"], u) <= TOL and close(port["t"], tf)
    pts, vals = jax["eval"][-1]
    for (s, x, val, exact, r), xj, vj in zip(port["rows"], pts[:, 0], vals):
        ej = float(mendousse(xj, tf, 1500.0, 1e6, 5e6, 1000.0, 4.8, delta0))
        assert close(x, xj) and close(val, vj) and close(exact, ej)
        assert close(r, abs(vj - ej) / (abs(ej) + 1e-3 * 5e6))
    return port


def test_mendousse_quick_matches_jax_over_a_third_horizon(jax):
    _mendousse(jax, 1.0 / 3.0)


@pytest.mark.slow
def test_mendousse_quick_matches_jax(jax):
    assert _mendousse(jax, 1.0)["ok"]

