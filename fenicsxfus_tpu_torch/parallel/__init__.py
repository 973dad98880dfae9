"""Domain decomposition over ``torch.distributed`` (the port of
``fenicsxfus_tpu/parallel/``): the slab decomposition (``slab.py``) and the
launcher that starts its ranks (``launch.py``)."""

from .launch import process_group, spawn  # noqa: F401
from .slab import (  # noqa: F401
    HaloSEMOperators,
    ShardedExplicitSolver,
    ShardedImplicitSolver,
    SlabDecomposition,
    build_sharded,
    collapse_onehot,
    lattice_interp_nodes,
    weighted_sensor_rows,
)
