"""The system under test: the defaults of an entry's program side, over the
port's models. An entry (``entries/<entry>.py``, found by the configuration's
``entry``) builds the cell's model through the port's ``drivers/`` modules
and may replace any function here (``cell.PROGRAM_HOOKS``). This module and
the entries are the only ones of the benchmark that import the port (besides
``spans.py``'s read of the port's span registry), and they read nothing but
the model, its state and its sensor traces.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def import_port() -> dict:
    """Import the port and, where there is a card, build (on first use, into
    the port's ``_build/`` inside the checkout, a fixed place, so only a
    checkout's first run compiles) and load its CUDA library. Returns
    whether this run compiled and the seconds the build took."""
    import fenicsxfus_tpu_torch  # noqa: F401
    from fenicsxfus_tpu_torch import _build

    if not torch.cuda.is_available():
        return {"compiled": False, "build_s": 0.0}
    _, build_s, _ = _build.build()
    _build.library()
    return {"compiled": build_s > 0.0, "build_s": build_s}


def lattice_shape(model) -> tuple:
    """The node lattice of the model's fields."""
    return tuple(model.ops.gdims)


def slab_cells(model) -> int:
    """Cells of the deformed slab (0 off a bowl-fitted lattice)."""
    hy = model.ops.hybrid
    return 0 if hy is None else int(hy["nb"])


def set_state(model, u: torch.Tensor, v: torch.Tensor) -> None:
    """Start the model from (u, v), flat lattice vectors of its dtype that
    the model takes over (no copy, so the run holds one state as a
    deployment does)."""
    model.u_n, model.v_n = u, v


def state(model):
    return model.u_n, model.v_n


def march_period(model, t0: float, tf: float, points: np.ndarray) -> torch.Tensor:
    """One period of the window: ``rk_record`` from t0 to tf on ``points``;
    returns the traces [steps, sensors], still on the device."""
    return model.rk_record(t0, tf, points)[4]


def wrap_plan(model, wrapper) -> None:
    """Put ``wrapper`` around the instance's per-call work of ``rk_record``
    on the host: the step's build (``_make_step``) and the sensors' plan
    (``_record_plan``)."""
    for name in ("_make_step", "_record_plan"):
        setattr(model, name, wrapper(name, getattr(model, name)))


def wrap_band(model, wrapper) -> bool:
    """Put ``wrapper`` around the instance's slab correction, if the model
    has one (``ops.band_correction_rows``); returns whether it did."""
    ops = model.ops
    if ops.hybrid is None:
        return False
    inner = ops.band_correction_rows
    ops.band_correction_rows = wrapper(inner)
    return True
