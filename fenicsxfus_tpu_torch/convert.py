"""Move model data from the JAX package's layout to the port's.

The JAX model's ``consts`` (read back as numpy, nested dicts included) map
one to one onto the port's, with one layout change: the packed stiffness
coefficient ``F2`` is stored transposed by the JAX package, [G0, n2|1, G1],
and as [G0, G1, n2|1] by the port (every ``F_a`` of the port is the lattice
shape with axis a replaced by n_a or 1). A hybrid (bowl-fitted) lattice's
coefficient {"hyb_u", "hyb_b", "hyb_G"} keeps its keys: ``hyb_u`` is packed
F tensors as above, ``hyb_b`` a tensor, and the slab's correction factors
``hyb_G`` go from the JAX package's [nb, N, N, N, 6] to the port's
component-major [6, nb, N, N, N]. The lattice scales of a 1D or 2D
coefficient (the JAX package's ``pack_scales``) keep their form: a list, per
axis, of (scalar, [vectors]) for a constant coefficient, a tuple of per-axis
scale tensors for a cell-resolved one, and so do the sponge's nodal scales
(``delta_scales``, the JAX package's ``pack_scales_nodal``: a tuple of
per-axis scale tensors; on the general path a raw [ndofs] array, which
becomes a tensor). The implicit models' vectors (``m``,
``kdiag``, ``kdiag_u``/``kdiag_v``, ``src_vec_d``) are plain arrays, and so
is a stiffness coefficient on the general per-cell path (the JAX
``stiff_coeff``'s [Nc] DG-0 array), which becomes a [Nc] tensor as the
port's own ``stiff_coeff`` gives it. Scalars
stay Python floats. Tensors go to the card unless ``device`` asks for the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import resolve_device

_F_KEYS = {"F0", "F1", "F2"}
_HYBRID_KEYS = {"hyb_u", "hyb_b", "hyb_G"}


def _tensor(arr, device, dtype) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(arr), dtype=dtype, device=resolve_device(device))


def coeff_from_jax(F: dict, device="cuda", dtype=torch.float64) -> dict:
    """Packed {F0, F1, F2} of the JAX package → the port's layout."""
    return {
        "F0": _tensor(np.asarray(F["F0"]), device, dtype),
        "F1": _tensor(np.asarray(F["F1"]), device, dtype),
        "F2": _tensor(np.swapaxes(np.asarray(F["F2"]), 1, 2), device, dtype),
    }


def hybrid_coeff_from_jax(c: dict, device="cuda", dtype=torch.float64) -> dict:
    """A hybrid coefficient {hyb_u, hyb_b, hyb_G} of the JAX package (its
    ``hyb_u`` packed as {F0, F1, F2}) → the port's layout."""
    return {
        "hyb_u": coeff_from_jax(c["hyb_u"], device, dtype),
        "hyb_b": _tensor(np.asarray(c["hyb_b"]), device, dtype),
        "hyb_G": _tensor(np.moveaxis(np.asarray(c["hyb_G"]), -1, 0), device, dtype),
    }


def scales_from_jax(scales, device="cuda", dtype=torch.float64):
    """Lattice scales of the JAX package's ``pack_scales`` → the port's: a
    list of (scalar, [vectors]) per axis stays one, with float scalars and
    tensor vectors; per-axis scale arrays become a tuple of tensors."""
    if all(isinstance(s, tuple) and len(s) == 2 and np.ndim(s[0]) == 0 for s in scales):
        return [(float(fac), [_tensor(np.asarray(v), device, dtype) for v in vecs])
                for fac, vecs in scales]
    return tuple(_tensor(np.asarray(s), device, dtype) for s in scales)


def consts_from_numpy(consts: dict, device="cuda", dtype=torch.float64) -> dict:
    """The JAX model's ``consts`` (numpy arrays, floats, nested dicts, lists
    of lattice scales) as the port's: tensors of ``dtype`` on ``device``,
    F-packed coefficients and lattice scales in the port's layout, scalars
    as floats."""
    out = {}
    for k, v in consts.items():
        if isinstance(v, (list, tuple)):
            out[k] = scales_from_jax(v, device, dtype)
        elif isinstance(v, dict):
            if set(v) == _F_KEYS:
                out[k] = coeff_from_jax(v, device, dtype)
            elif set(v) == _HYBRID_KEYS:
                out[k] = hybrid_coeff_from_jax(v, device, dtype)
            else:
                out[k] = {n: _tensor(np.asarray(a), device, dtype) for n, a in v.items()}
        elif np.ndim(v) == 0:
            out[k] = float(v)
        else:
            out[k] = _tensor(np.asarray(v), device, dtype)
    return out


def state_from_numpy(u, v, device="cuda", dtype=torch.float64):
    """The JAX model's state (u, v) as flat tensors of the port."""
    return field_from_numpy(u, device, dtype), field_from_numpy(v, device, dtype)


def field_from_numpy(a, device="cuda", dtype=torch.float64) -> torch.Tensor:
    """One field of the JAX model's state as a flat tensor of the port
    (Newmark's acceleration ``w_n`` beside ``state_from_numpy``'s u, v)."""
    return _tensor(np.asarray(a).reshape(-1), device, dtype)
