"""Start the ranks of a ``torch.distributed`` job, one process per rank.

``spawn(fn, world, backend, device)`` runs ``fn(device, *args, **kwargs)``
in ``world`` fresh interpreters (``torch.multiprocessing`` with the spawn
start method), each with its process group initialised, and returns the
ranks' results in rank order. The ranks meet through a ``FileStore`` in a
new temporary directory (under ``store_dir`` if given), never a fixed TCP
port, so concurrent launches cannot collide. Each rank runs one thread.

A rank that raises fails the whole launch: the other ranks are ended and
``spawn`` raises with that rank's traceback. A launch that outlives
``timeout`` seconds is killed and raises too; the process group gets the
same timeout, so a rank waiting on a dead peer gives up rather than hangs.

Backends: ``gloo`` (the CPU, or ranks that share one card and exchange
through host buffers) and ``nccl`` (one rank per card). ``process_group``
makes a group in the calling process, as a world of one on the card does in
``chip_smoke.py``.

    python -m fenicsxfus_tpu_torch.examples.sharded_planewave3d --world 2 --device cpu
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils import resolve_device

DEFAULT_TIMEOUT = 600.0
THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(backend: str, device, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, the one card ``device`` that every
    gloo rank shares, or card ``rank`` under NCCL (one rank per card; NCCL
    refuses two ranks on one device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and backend == "nccl":
        if rank >= torch.cuda.device_count():
            raise ValueError(f"NCCL holds one rank per card: rank {rank} has no card "
                             f"({torch.cuda.device_count()} visible)")
        return torch.device("cuda", rank)
    return dev


@contextlib.contextmanager
def process_group(backend: str, rank: int = 0, world: int = 1, store_dir=None,
                  timeout: float = DEFAULT_TIMEOUT):
    """Initialise the default process group through a ``FileStore`` in
    ``store_dir`` (a new temporary directory if None), and destroy it on
    exit."""
    with contextlib.ExitStack() as stack:
        if store_dir is None:
            store_dir = stack.enter_context(tempfile.TemporaryDirectory())
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            yield
        finally:
            dist.destroy_process_group()


def spawn(fn, world: int, backend=None, device="cuda", store_dir=None, args=(), kwargs=None,
          timeout: float = DEFAULT_TIMEOUT) -> list:
    """Run ``fn(device, *args, **kwargs)`` on ``world`` ranks and return their
    results in rank order. ``fn``, its arguments and its results must
    pickle (``fn`` a module-level function of an importable module), and
    a script that calls ``spawn`` keeps its own work under ``if __name__ ==
    "__main__":`` (the ranks import the caller's main module, as the spawn
    start method does). ``backend`` defaults to NCCL on the card and gloo
    on the CPU."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL holds one rank per card: {world} ranks, "
                         f"{torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        with _environ(THREAD_ENV):
            ctx = mp.start_processes(
                _rank_main, args=(tmp, world, backend, str(dev), timeout, fn, tuple(args),
                                  dict(kwargs or {})),
                nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    running = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
                    raise TimeoutError(f"ranks {running} still running after {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"rank {e.error_index} of {world} failed: {e}") from None
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


@contextlib.contextmanager
def _environ(values: dict):
    """``os.environ`` with ``values`` set inside the block (the ranks
    inherit it), restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rank_main(rank: int, tmp: str, world: int, backend: str, device: str, timeout: float,
               fn, args: tuple, kwargs: dict) -> None:
    """One rank: set its device, join the group, run the job, save the result
    (written under another name, then renamed into place)."""
    torch.set_num_threads(1)
    dev = rank_device(backend, device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with process_group(backend, rank, world, tmp, timeout):
        result = fn(dev, *args, **kwargs)
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".part", path)
