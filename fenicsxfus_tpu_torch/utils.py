"""Utility functions (port of ``fenicsxfus_tpu/utils.py``, reference
``python/src/fenicsxfus/utils.py``)."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device with an explicit index; raises when CUDA
    is asked for and is not available (the port's entry points default to
    ``"cuda"``, and CPU runs ask for ``"cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def compute_diffusivity_of_sound(frequency: float, speed: float, attenuationdB: float) -> float:
    """Convert attenuation in dB/m to the diffusivity-of-sound δ
    (reference ``utils.py:50-55``): δ = 2 α_Np c³ / ω²."""
    attenuationNp = attenuationdB / 20 * np.log(10)
    return 2 * attenuationNp * speed**3 / frequency / frequency
