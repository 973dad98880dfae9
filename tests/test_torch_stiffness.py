"""K1, the packed lattice stiffness of the PyTorch port, against the JAX
package: packing (with the F2 layout mapping pinned), the plain torch version
against ``apply_v3`` run in Pallas interpret mode and against the XLA lattice
``apply_scaled``, and the wrapper's checks. Same tolerance as
``tests/test_pallas.py``: fp64, max|Δ| < 1e-12·max|y|.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsxfus_tpu.core.mesh import create_box
from fenicsxfus_tpu.ops.operators import SEMOperators as JaxOps
from fenicsxfus_tpu.ops.pallas_lattice import LatticePallasStiffness
from fenicsxfus_tpu_torch.convert import coeff_from_jax
from fenicsxfus_tpu_torch.ops.lattice import LatticeStiffness
from fenicsxfus_tpu_torch.ops.stiffness import (
    pack_const,
    pack_field,
    stiffness_apply,
    stiffness_plain,
)

torch.set_num_threads(1)

GRID, HI = (9, 5, 7), (0.9, 0.7, 0.5)
CASES = ["const", "dg0", "dg0 2 fields"]


def _setup(degree, seed=0):
    jops = JaxOps(create_box(GRID, (0, 0, 0), HI), degree, dtype=jnp.float64)
    jlat = jops.lattice
    tlat = LatticeStiffness(jlat.grid, degree, jlat.h, torch.float64)
    rng = np.random.default_rng(seed)
    coeffs = [rng.uniform(0.5, 2.0, int(np.prod(GRID))) for _ in range(2)]
    xs = [rng.standard_normal(jlat.gdims) for _ in range(2)]
    return jlat, tlat, coeffs, xs


def _close(y, y_ref, tol=1e-12):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    err = np.max(np.abs(y - y_ref))
    assert err < tol * np.max(np.abs(y_ref)), err


@pytest.mark.parametrize("degree", [2, 3, 4])
def test_pack_matches_jax_layout(degree):
    """Port packing == JAX packing after the layout map; F2 is the only
    tensor whose layout differs ([G0, n2|1, G1] → [G0, G1, n2|1])."""
    jlat, tlat, coeffs, _ = _setup(degree)
    pk = LatticePallasStiffness(jlat, interpret=True)
    for jF, tF in [(pk.pack_const(1.7), pack_const(tlat, 1.7, "cpu")),
                   (pk.pack_field(coeffs[0]), pack_field(tlat, coeffs[0], "cpu"))]:
        mapped = coeff_from_jax({k: np.asarray(v) for k, v in jF.items()}, device="cpu")
        for k in ("F0", "F1", "F2"):
            assert torch.equal(mapped[k], tF[k]), k
        assert np.array_equal(np.swapaxes(np.asarray(jF["F2"]), 1, 2), tF["F2"].numpy())
        assert tF["F2"].shape[:2] == jlat.gdims[:2]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("degree", [2, 3, 4, 5, 6])
def test_plain_matches_apply_v3(degree, case):
    """The plain K1 version against the TPU kernel in interpret mode, at
    every degree with a compiled tile (csrc/tiles.cuh) among them."""
    jlat, tlat, coeffs, xs = _setup(degree)
    pk = LatticePallasStiffness(jlat, interpret=True)
    if case == "const":
        jFs, tFs, n = [pk.pack_const(1.7)], [pack_const(tlat, 1.7, "cpu")], 1
    elif case == "dg0":
        jFs, tFs, n = [pk.pack_field(coeffs[0])], [pack_field(tlat, coeffs[0], "cpu")], 1
    else:
        jFs = [pk.pack_field(c) for c in coeffs]
        tFs, n = [pack_field(tlat, c, "cpu") for c in coeffs], 2
    y_jax = pk.apply([jnp.asarray(x) for x in xs[:n]], jFs)
    y = stiffness_apply([torch.from_numpy(x) for x in xs[:n]], tFs, degree)
    _close(y.numpy(), y_jax)


@pytest.mark.parametrize("degree", [2, 3, 4])
def test_plain_matches_apply_scaled(degree):
    """The packed K1 form against the unpacked B_aᵀ(S_a∘B_a x) form, in the
    JAX package (XLA) and in the port (torch), constant and DG-0."""
    jlat, tlat, coeffs, xs = _setup(degree, seed=1)
    x0, x1 = torch.from_numpy(xs[0]), torch.from_numpy(xs[1])
    y = stiffness_plain([x0], [pack_const(tlat, 1.7, "cpu")], degree)
    scales = jlat.scales_const(1.7)
    y_jax = jax.jit(lambda x: jlat.apply_scaled([(x, scales)]))(jnp.asarray(xs[0]))
    _close(y.numpy(), y_jax)
    _close(y.numpy(), tlat.apply_scaled([(x0, tlat.scales_const(1.7))]).numpy())
    y = stiffness_plain([x0, x1], [pack_field(tlat, c, "cpu") for c in coeffs], degree)
    pairs = [(x, tlat.scales_field(c)) for x, c in zip((x0, x1), coeffs)]
    _close(y.numpy(), tlat.apply_scaled(pairs).numpy())


def test_wrapper_checks_and_cpu_route():
    _, tlat, coeffs, xs = _setup(2)
    x = torch.from_numpy(xs[0])
    F = pack_field(tlat, coeffs[0], "cpu")
    before = stiffness_apply.launches
    assert torch.equal(stiffness_apply([x], [F], 2), stiffness_plain([x], [F], 2))
    assert stiffness_apply.launches == before  # the CPU route launches nothing
    with pytest.raises(ValueError):
        stiffness_apply([x.float()], [F], 2)  # dtype mismatch with F
    with pytest.raises(ValueError):
        stiffness_apply([x.transpose(0, 1).contiguous().transpose(0, 1)], [F], 2)
    with pytest.raises(ValueError):
        stiffness_apply([x], [F], 3)  # not a degree-3 lattice
    with pytest.raises(ValueError):
        stiffness_apply([x], [{**F, "F2": F["F2"].transpose(1, 2)}], 2)
    with pytest.raises(ValueError):
        stiffness_apply([x, x, x], [F, F, F], 2)
