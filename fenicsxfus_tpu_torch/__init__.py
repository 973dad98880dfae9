"""fenicsxfus_tpu_torch — the PyTorch/CUDA port of fenicsxfus_tpu.

The port runs the spectral-element focused-ultrasound framework on NVIDIA
Hopper GPUs (H100): host setup in numpy, fields as torch tensors, and the
lattice kernels hand-written in CUDA C++ (``csrc/``), compiled by ``nvcc`` at
first use (``_build.py``). It imports no jax. The JAX package
``fenicsxfus_tpu`` stays the reference the port is held against.

Ported so far: the explicit-RK models ``LinearSpectralExplicit``,
``LossySpectralExplicit``, ``WesterveltSpectralExplicit`` and
``WesterveltSpectralFocused`` on a uniform ``create_box`` lattice, with point
sensors and in-loop recording (``rk_record``), the HITU focused-bowl driver
(``drivers/hitu.py``), the K1 stiffness kernel (``ops/stiffness.py``), the
K2 fused RK-stage kernel for all four model kinds (``ops/stage.py``), and the
two-kernel pipeline of the JAX package: K4a/K4b, the stiffness split at the
axis-0 / axes-1,2 boundary (``ops/stiffness.py``, selected by ``FUS_V3=0``),
and K5a/K5b, the RK stage split the same way (``ops/stage_ab.py``, selected
by ``FUS_STAGE_V3=0``). Entry points run on the card unless the caller asks
for the CPU (``device="cpu"``).
"""

from .core.mesh import Mesh, create_box, create_interval, create_rectangle, tag_boundaries  # noqa: F401
from .models.focused import WesterveltSpectralFocused, bowl_delays  # noqa: F401
from .models.linear import LinearSpectralExplicit  # noqa: F401
from .models.lossy import LossySpectralExplicit  # noqa: F401
from .models.westervelt import WesterveltSpectralExplicit  # noqa: F401
from .ops.operators import SEMOperators  # noqa: F401
from .utils import compute_diffusivity_of_sound  # noqa: F401

__all__ = [
    "Mesh",
    "create_box",
    "create_interval",
    "create_rectangle",
    "tag_boundaries",
    "SEMOperators",
    "LinearSpectralExplicit",
    "LossySpectralExplicit",
    "WesterveltSpectralExplicit",
    "WesterveltSpectralFocused",
    "bowl_delays",
    "compute_diffusivity_of_sound",
]

__version__ = "0.1.0"
