"""Utility functions (port of ``fenicsxfus_tpu/utils.py``, reference
``python/src/fenicsxfus/utils.py``)."""

from __future__ import annotations

import numpy as np


def compute_diffusivity_of_sound(frequency: float, speed: float, attenuationdB: float) -> float:
    """Convert attenuation in dB/m to the diffusivity-of-sound δ
    (reference ``utils.py:50-55``): δ = 2 α_Np c³ / ω²."""
    attenuationNp = attenuationdB / 20 * np.log(10)
    return 2 * attenuationNp * speed**3 / frequency / frequency
