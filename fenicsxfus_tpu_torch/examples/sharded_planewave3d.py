"""Multi-rank 3D planewave over the slab decomposition (the MPI-scaling
analogue): the port of ``examples/sharded_planewave3d.py``. ``main`` starts
``world`` ranks (``parallel.launch.spawn``; default one per card on the
card, 2 gloo ranks on the CPU), each builds the model and runs
``ShardedExplicitSolver`` on its slab, fp32 as the JAX script. On the card
NCCL holds one rank per card; ``--backend gloo`` puts several ranks on one
card, their halo planes through host buffers.

    python -m fenicsxfus_tpu_torch.examples.sharded_planewave3d --world 2 --device cpu
"""

import torch
import torch.distributed as dist

from ..core.mesh import create_box, tag_boundaries
from ..models.linear import LinearSpectralExplicit
from ..parallel.launch import spawn
from ..parallel.slab import ShardedExplicitSolver
from ..scripts import cli, device_dtype


def main(nx=16, degree=3, world=0, backend=None, device="cuda", dtype=None, depth=1.0):
    dev, dtype = device_dtype(device, dtype, cpu_dtype=torch.float32)
    world = world or (torch.cuda.device_count() if dev.type == "cuda" else 2)
    res = spawn(rank_run, world, backend, dev, args=(nx, degree, dtype, depth))[0]
    print(f"{res['ndev']} devices, {res['ndofs']} DOFs, max|u| = {res['max_u']:.1f}")
    return res


def rank_run(device, nx, degree, dtype, depth):
    """One rank of ``main``: the whole model, then this rank's slab of the
    sharded run; the global u on every rank."""
    ndev = dist.get_world_size()
    f0, p0, c0, rho0 = 0.5e6, 60000.0, 1500.0, 1000.0
    L = 0.12
    nx = (nx // ndev) * ndev or ndev
    mesh = create_box((nx, nx // 2 or 1, nx // 2 or 1), (0, 0, 0), (L, L / 2, L / 2))
    tag_boundaries(mesh, {1: lambda x: x[0] < 1e-9}, default=2)
    dt = 0.9 * (L / nx) / (c0 * degree**2)
    eqn = LinearSpectralExplicit(mesh, None, degree, c0, rho0, f0, p0, c0, 4, dt,
                                 dtype=dtype, device=device)
    eqn.init()
    solver = ShardedExplicitSolver(eqn, device=device)
    u, _, tf = solver.rk(0.0, depth * 0.3 * L / c0)
    return {"ndev": ndev, "ndofs": eqn.number_of_dofs(), "max_u": float(u.abs().max()),
            "u": u.cpu().numpy(), "t": tf}


if __name__ == "__main__":
    cli(main, __doc__.splitlines()[0])
