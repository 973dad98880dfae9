"""Move model data from the JAX package's layout to the port's.

The JAX model's ``consts`` (read back as numpy, nested dicts included) map
one to one onto the port's, with one layout change: the packed stiffness
coefficient ``F2`` is stored transposed by the JAX package, [G0, n2|1, G1],
and as [G0, G1, n2|1] by the port (every ``F_a`` of the port is the lattice
shape with axis a replaced by n_a or 1). Scalars stay Python floats. Tensors
go to the card unless ``device`` asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import resolve_device

_F_KEYS = {"F0", "F1", "F2"}


def _tensor(arr, device, dtype) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(arr), dtype=dtype, device=resolve_device(device))


def coeff_from_jax(F: dict, device="cuda", dtype=torch.float64) -> dict:
    """Packed {F0, F1, F2} of the JAX package → the port's layout."""
    return {
        "F0": _tensor(np.asarray(F["F0"]), device, dtype),
        "F1": _tensor(np.asarray(F["F1"]), device, dtype),
        "F2": _tensor(np.swapaxes(np.asarray(F["F2"]), 1, 2), device, dtype),
    }


def consts_from_numpy(consts: dict, device="cuda", dtype=torch.float64) -> dict:
    """The JAX model's ``consts`` (numpy arrays, floats, nested dicts) as the
    port's: tensors of ``dtype`` on ``device``, F-packed coefficients in the
    port's layout, scalars as floats."""
    out = {}
    for k, v in consts.items():
        if isinstance(v, dict):
            if set(v) == _F_KEYS:
                out[k] = coeff_from_jax(v, device, dtype)
            else:
                out[k] = {n: _tensor(np.asarray(a), device, dtype) for n, a in v.items()}
        elif np.ndim(v) == 0:
            out[k] = float(v)
        else:
            out[k] = _tensor(np.asarray(v), device, dtype)
    return out


def state_from_numpy(u, v, device="cuda", dtype=torch.float64):
    """The JAX model's state (u, v) as flat tensors of the port."""
    return (
        _tensor(np.asarray(u).reshape(-1), device, dtype),
        _tensor(np.asarray(v).reshape(-1), device, dtype),
    )
