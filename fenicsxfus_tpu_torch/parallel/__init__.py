"""Domain decomposition over ``torch.distributed`` (the port of
``fenicsxfus_tpu/parallel/``): the slab decomposition (``slab.py``), the
block decomposition over a grid of ranks (``grid.py``), the partition of
unstructured meshes (``unstructured.py``), the launcher that starts their
ranks (``launch.py``) and the dry run of all three (``dryrun.py``)."""

from .grid import (  # noqa: F401
    GridDecomposition,
    HaloNDSEMOperators,
    ShardedExplicitSolver2D,
    ShardedImplicitSolverND,
    build_sharded_grid,
)
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
from .unstructured import (  # noqa: F401
    LocalUnstructuredOps,
    ShardedUnstructuredExplicitSolver,
    ShardedUnstructuredImplicitSolver,
    UnstructuredDecomposition,
    partition_tables,
)
