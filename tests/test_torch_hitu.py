"""The port's HITU driver (``fenicsxfus_tpu_torch/drivers/hitu.py``) against
the JAX package's (``benchmarks/hitu/common.py``, loaded as
``tests/test_hitu.py`` loads it): scenario constants, the phased-aperture
delays, and a small fp64 run whose steady axial amplitudes agree to 1e-10.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsxfus_tpu.models.focused import bowl_delays as jax_bowl_delays
from fenicsxfus_tpu_torch import bowl_delays
from fenicsxfus_tpu_torch.drivers import hitu

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "hitu_common",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "benchmarks", "hitu", "common.py"),
)
jax_hitu = importlib.util.module_from_spec(_spec)
sys.modules["hitu_common"] = jax_hitu
_spec.loader.exec_module(jax_hitu)


def test_constants_match_jax_driver():
    for name in ("TRANSDUCERS", "MEDIA", "F0_FULL", "SOURCE_VELOCITY"):
        assert getattr(hitu, name) == getattr(jax_hitu, name), name


def test_bowl_delays_match_jax():
    rng = np.random.default_rng(0)
    coords = np.stack([rng.uniform(0, 0.01, 500), rng.uniform(-0.04, 0.04, 500),
                       rng.uniform(-0.04, 0.04, 500)])
    for obliquity in (True, False):
        got = bowl_delays(coords, np.zeros(3), 0.032, 0.0632, 1480.0, obliquity=obliquity)
        ref = jax_bowl_delays(coords, np.zeros(3), 0.032, 0.0632, 1480.0, obliquity=obliquity)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_small_run_matches_jax():
    """``run`` at the size of ``tests/test_hitu.py::test_hitu_smoke``, fp64:
    the port (fused ``focused`` K2 step, plain on the CPU) against the JAX
    driver (its default path on the CPU, the unfused scan)."""
    kw = dict(nx=10, degree=2, f0=1e5, final_time=8e-6)
    x_ref, amp_ref = jax_hitu.run("W", "H101", "WATER", dtype=jnp.float64, **kw)
    res = hitu.run("W", "H101", "WATER", dtype=torch.float64, device="cpu", **kw)
    assert res.model.step_kind == "fused" and res.nsteps == 11
    np.testing.assert_array_equal(res.x, x_ref)
    assert np.max(np.abs(res.amplitude - amp_ref)) < 1e-10 * np.max(np.abs(amp_ref))


def test_bowl_mesh_is_not_ported():
    with pytest.raises(NotImplementedError):
        hitu.run("W", "H101", "WATER", nx=6, degree=2, f0=1e5, final_time=1e-6, bowl=True,
                 device="cpu")
