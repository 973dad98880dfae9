"""Checkpoint / resume for time-stepped runs (port of
``fenicsxfus_tpu/io/checkpoint.py``).

The reference has no checkpointing (its RK loop state is (u_, v_, t)). The
file is the JAX package's ``.npz``, key for key (``u_n``, ``v_n``, ``t``,
``ndofs``, ``degree``, ``dim``, ``model`` and Newmark's ``w_n``), so a
checkpoint written by either package resumes in the other: the fields are
copied to the host on save and to the model's device and dtype on load.
"""

from __future__ import annotations

import numpy as np
import torch


def save_checkpoint(path: str, model, extra: dict | None = None) -> None:
    """Snapshot a model's time-stepping state (u_n, v_n, t [, w_n])."""
    data = {
        "u_n": model.u_n.cpu().numpy(),
        "v_n": model.v_n.cpu().numpy(),
        "t": float(model.t),
        "ndofs": model.ops.ndofs,
        "degree": model.degree,
        "dim": model.mesh.dim,
        "model": type(model).__name__,
    }
    if hasattr(model, "w_n"):  # Newmark carries the acceleration
        data["w_n"] = model.w_n.cpu().numpy()
    for k, v in (extra or {}).items():
        data[f"extra_{k}"] = v
    np.savez_compressed(path, **data)


def load_checkpoint(path: str, model) -> float:
    """Restore state into a compatible model (same DOF count and model
    class); returns the checkpoint time."""
    data = np.load(path, allow_pickle=False)
    if int(data["ndofs"]) != model.ops.ndofs:
        raise ValueError(
            f"checkpoint has {int(data['ndofs'])} dofs, model has {model.ops.ndofs}"
        )
    if str(data["model"]) != type(model).__name__:
        raise ValueError(
            f"checkpoint from {data['model']}, restoring into {type(model).__name__}"
        )

    def field(key):
        return torch.as_tensor(data[key], dtype=model.dtype, device=model.device).reshape(-1)

    model.u_n = field("u_n")
    model.v_n = field("v_n")
    model.t = float(data["t"])
    if "w_n" in data and hasattr(model, "w_n"):
        model.w_n = field("w_n")
    return model.t
