"""Block decomposition over a (d0 × d1[ × d2]) grid of ``torch.distributed``
ranks.

Port of ``fenicsxfus_tpu/parallel/grid.py``: the slab decomposition
split along several leading mesh axes, the arbitrary-partition analogue of
the reference's cell partitioner
(``cpp/fenicsx-sf/tests/test_operators3d/main.cpp:31``), for domains that are
not elongated along one axis. Each rank is a process that holds only its own
block:

* rank r holds block ``np.unravel_index(r, dshape)`` (row-major, the order in
  which the JAX package stacks its devices' blocks);
* interface DOF planes are replicated on every block that touches them, and
  every mass-type diagonal is assembled globally once, so pointwise updates
  keep the replicas identical;
* the only communication of a step is completing the stiffness assembly
  (``slab.HaloSEMOperators.complete``): one neighbour exchange per
  partitioned axis, axis 0 first, each adding the previous neighbour's plane and then the
  next one's to the sums of the exchanges before it, so the later axes carry
  the edge and corner sums (a point shared by 2^k blocks is complete after k
  exchanges); no atomics, no diagonal-neighbour messages;
* the CG of the implicit path sums a replica-weighted local dot over the
  ranks (``all_reduce``).

Cell counts need not divide the grid: each axis is padded with inert cells
(zero stiffness coefficient, zero fields, dot weight 0, 1 on the diagonals
the solver divides by), so every rank holds the same local lattice, whose
operators are those of the first block. On a 3D block the explicit step runs
K1 once per stage and the CG runs fp64 K1; a 1D or 2D block runs
``apply_scaled``, as in the JAX package.

The decomposition itself (``GridDecomposition``) and the streamed build
live in ``parallel/slab.py``, whose slab is its one-axis case;
``build_sharded_grid`` builds each rank's block alone from a model factory
(host memory O(local)), and the interface sums of its raw consts run in
float64 through the same per-axis exchange (the JAX package completes them
on the host, fastest axis first: the two differ by rounding only).
"""

from __future__ import annotations

from .slab import (
    GridDecomposition,
    HaloSEMOperators,
    ShardedExplicitSolver,
    ShardedImplicitSolver,
    build_streamed,
)

__all__ = ["GridDecomposition", "HaloNDSEMOperators", "ShardedExplicitSolver2D",
           "ShardedImplicitSolverND", "build_sharded_grid"]

# the JAX package's name for the halo operators on several axes; one class
# serves the slab and the grid
HaloNDSEMOperators = HaloSEMOperators


def _grid_dec(model, dshape, device):
    return GridDecomposition(model.mesh, model.degree, dshape, model.dtype, device)


class ShardedExplicitSolver2D(ShardedExplicitSolver):
    """Run an explicit model's unfused step over a (d0, d1[, d2]) grid of
    ranks, one block each: the multi-axis counterpart of
    ``slab.ShardedExplicitSolver`` (``rk``, ``rk_record``,
    ``global_result``).

    Usage, on every rank of a group of d0·d1 ranks::

        model = LinearSpectralExplicit(mesh, ..., device=device)   # global setup
        sharded = ShardedExplicitSolver2D(model, (d0, d1), device=device)
        u, v, t = sharded.rk(t0, tf)                                # == model.rk(t0, tf)
    """

    def __init__(self, model, dshape, device="cuda"):
        super().__init__(model, dshape, device)

    _make_dec = staticmethod(_grid_dec)


class ShardedImplicitSolverND(ShardedImplicitSolver):
    """SDIRK over a grid of ranks: each rank's CG applies its block's
    ``lhs_pure`` (fp64 K1 on a 3D block, completed by the per-axis
    exchange) and reduces its replica-weighted dots over the ranks
    (``dirk``, ``dirk_record``, ``global_result``)."""

    def __init__(self, model, dshape, device="cuda"):
        super().__init__(model, dshape, device)

    _make_dec = staticmethod(_grid_dec)


def build_sharded_grid(model_factory, grid, lo, hi, degree, dshape, dtype,
                       implicit: bool = False, device="cuda"):
    """A grid-sharded solver whose host memory is O(ndofs / ranks): each
    rank builds the model on its own block only (``slab.build_streamed``;
    the interface planes must match none of the factory's boundary
    predicates)."""
    dec = GridDecomposition.from_grid(grid, lo, hi, degree, dshape, dtype, device)
    return build_streamed(dec, model_factory, implicit,
                          ShardedImplicitSolverND if implicit else ShardedExplicitSolver2D)
