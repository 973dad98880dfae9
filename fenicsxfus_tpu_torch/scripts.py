"""What the port's example, experiment and benchmark scripts share
(``examples/``, ``experiments/``, ``drivers/mendousse.py``): the device and
dtype they run on, and their command line.

Each script's ``main`` runs on the card unless it is given ``device="cpu"``,
in the dtype its JAX counterpart takes on that backend (fp32 on the card,
fp64 on the CPU) unless it is given ``dtype``, and marches the fraction
``depth`` of its time horizon (1: the whole run; ``chip_smoke.py`` cuts it to
fit its time limit). It returns what it computed as a dict.
"""

from __future__ import annotations

import argparse
import inspect

import torch

from .utils import resolve_device


def device_dtype(device, dtype=None, cpu_dtype=torch.float64) -> tuple:
    """(torch.device, dtype) of a script's run: ``dtype`` if given, else
    ``cpu_dtype`` on the CPU and fp32 on the card."""
    dev = resolve_device(device)
    return dev, dtype or (cpu_dtype if dev.type == "cpu" else torch.float32)


def cli(main, description: str) -> dict:
    """Run ``main`` with its keyword arguments from the command line: one
    ``--name`` per parameter, typed by its default (a bool is a flag;
    ``--dtype float32|float64``). Keyword-only parameters are for callers
    in Python and have no flag."""
    ap = argparse.ArgumentParser(description=description)
    for name, par in inspect.signature(main).parameters.items():
        if par.kind is par.KEYWORD_ONLY:
            continue
        default = par.default
        if name == "dtype":
            ap.add_argument("--dtype", default=None, type=lambda s: getattr(torch, s))
        elif isinstance(default, bool):
            ap.add_argument(f"--{name}", action="store_true")
        else:
            ap.add_argument(f"--{name}", default=default,
                            type=str if default is None else type(default))
    return main(**vars(ap.parse_args()))
