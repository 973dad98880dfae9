"""K5a, the first kernel of the two-kernel RK stage of the PyTorch port,
against the JAX package's ``FusedRKStage.call_A`` (``ops/pallas_stage.py``)
run in Pallas interpret mode: fp64, max|Δ| < 1e-12·max|ref|, every model kind
with constant and DG-0 coefficients, at the first, a middle and the final
stage (operands of ``tests/test_torch_stage_ab.py``).
"""

import jax.numpy as jnp
import pytest
import torch

from fenicsxfus_tpu_torch.ops.stage_ab import stage_a_apply
from test_torch_stage import KINDS, P
from test_torch_stage_ab import SHAPES, _case, _close, _jax

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_stage_a_matches_call_A(kind, hetero, shape):
    stage, operands, a = _case(kind, hetero, shape)
    scal = jnp.asarray(a["scal"], jnp.float64).reshape(1, -1)
    ref = stage.call_A(_jax(a["u0"]), _jax(a["v0"]), _jax(a["kvp"]), _jax(a["kvpp"]), scal,
                       operands[1])
    got = stage_a_apply(kind, a["u0"], a["v0"], a["kvp"], a["kvpp"], a["Fs"], a["scal"], P)
    _close(got, ref)
