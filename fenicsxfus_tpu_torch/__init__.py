"""fenicsxfus_tpu_torch — the PyTorch/CUDA port of fenicsxfus_tpu.

The port runs the spectral-element focused-ultrasound framework on NVIDIA
Hopper GPUs (H100): host setup in numpy, fields as torch tensors, and the
lattice kernels hand-written in CUDA C++ (``csrc/``), compiled by ``nvcc`` at
first use (``_build.py``). It imports no jax. The JAX package
``fenicsxfus_tpu`` stays the reference the port is held against.

Ported so far: the explicit-RK models ``LinearSpectralExplicit``,
``LossySpectralExplicit``, ``WesterveltSpectralExplicit`` and
``WesterveltSpectralFocused``, the SDIRK models ``LinearSpectralImplicit``
and ``LossySpectralImplicit`` (Jacobi-preconditioned CG, ``ops/cg.py``, K1
its matvec in 3D), the rest of the JAX package's model family (Newmark, the
windowed-source S2, the nodal-δ sponge, adaptive RK45, the Gauss-quadrature
``LinearExplicit``; ``models/experimental.py``, ``ops/quadrature_ops.py``)
with the 2D scattering oracles, timers (``analysis/timing.py``) and
checkpoints (``io/checkpoint.py``, the JAX package's ``.npz``) on uniform ``create_interval``, ``create_rectangle`` and
``create_box`` lattices (1D and 2D through the plain ``apply_scaled``, as the
JAX package has no kernel there), with point sensors, in-loop recording
(``rk_record``, ``dirk_record``) and ``eval_function``, the HITU focused-bowl driver
(``drivers/hitu.py``), the K1 stiffness kernel (``ops/stiffness.py``), the
K2 fused RK-stage kernel for all four model kinds (``ops/stage.py``), and the
two-kernel pipeline of the JAX package: K4a/K4b, the stiffness split at the
axis-0 / axes-1,2 boundary (``ops/stiffness.py``, selected by ``FUS_V3=0``),
and K5a/K5b, the RK stage split the same way (``ops/stage_ab.py``, selected
by ``FUS_STAGE_V3=0``), and the bowl-fitted mesh (``create_bowl_box``) on
the hybrid operator path: the uniform lattice's K1/K2 plus the deformed
slab's correction K6 (``ops/band.py``), which K2 takes as its band operand,
and the general per-cell operator path of any conforming quad/hex mesh
(unstructured meshes with the entity-blocked numbering, ``as_unstructured``
and ``reorder_locality``; deformed lattices; the bowl mesh under
``FUS_HYBRID=0``; uniform lattices that are not axis-aligned), plain torch
as in the JAX package's XLA path, with a deterministic fold; the native host
geometry library (``native/``), XDMF/HDF5 I/O (``io/xdmf.py``), and the
production drivers: every HITU variant (``drivers/hitu.py``, the 1.1 MHz
reference-scale run and ``check_artifact``), the PH1 transcranial suite
(``drivers/ph1.py``), the harmonic analysis (``drivers/harmonics.py``) and the
fp32 drift tool (``tools/fp32_drift.py``), and the JAX package's scripts: the
examples (``examples/``), the experiments (``experiments/``), MENDOUSSE
(``drivers/mendousse.py``) and the speed tools (``tools/operator_speed.py``,
``stage_attrib.py``, ``solver_speed.py``, ``hybrid_speed.py``), and the slab
domain decomposition on ``torch.distributed`` (``parallel/``: one process
per rank, gloo on the CPU, NCCL on the card). Entry points run on the card
unless the caller asks for the CPU (``device="cpu"``).
"""

from .analysis import timing as _timing

with _timing.span("fus.import"):
    from .core.bowl import bowl_cap_area, create_bowl_box  # noqa: F401
    from .core.mesh import (  # noqa: F401
        Mesh,
        as_unstructured,
        create_box,
        create_interval,
        create_rectangle,
        reorder_locality,
        tag_boundaries,
    )
    from .analysis.analytical import (  # noqa: F401
        PenetrableExact2D,
        SoundHardExact2D,
        SoundSoftExact2D,
    )
    from .models.experimental import (  # noqa: F401
        LinearSpectralAdaptive,
        LinearSpectralNewmark,
        LinearSpectralS2,
        LinearSpectralSciPy,
        LinearSpectralSponge,
        WesterveltSpectralAdaptive,
        WesterveltSpectralSciPy,
    )
    from .models.focused import WesterveltSpectralFocused, bowl_delays  # noqa: F401
    from .models.linear import (  # noqa: F401
        LinearExplicit,
        LinearSpectralExplicit,
        LinearSpectralImplicit,
    )
    from .models.lossy import LossySpectralExplicit, LossySpectralImplicit  # noqa: F401
    from .models.westervelt import WesterveltSpectralExplicit  # noqa: F401
    from .ops.operators import SEMOperators  # noqa: F401
    from .utils import (  # noqa: F401
        compute_diffusivity_of_sound,
        compute_eval_params,
        estimate_stable_dt,
        eval_function,
    )


__all__ = [
    "Mesh",
    "as_unstructured",
    "bowl_cap_area",
    "create_box",
    "create_bowl_box",
    "create_interval",
    "create_rectangle",
    "reorder_locality",
    "tag_boundaries",
    "SEMOperators",
    "LinearExplicit",
    "LinearSpectralExplicit",
    "LinearSpectralImplicit",
    "LossySpectralExplicit",
    "LossySpectralImplicit",
    "WesterveltSpectralExplicit",
    "WesterveltSpectralFocused",
    "bowl_delays",
    "LinearSpectralNewmark",
    "LinearSpectralS2",
    "LinearSpectralSponge",
    "LinearSpectralAdaptive",
    "LinearSpectralSciPy",
    "WesterveltSpectralAdaptive",
    "WesterveltSpectralSciPy",
    "SoundHardExact2D",
    "SoundSoftExact2D",
    "PenetrableExact2D",
    "compute_diffusivity_of_sound",
    "compute_eval_params",
    "estimate_stable_dt",
    "eval_function",
]

__version__ = "0.1.0"
