"""Shared fixtures of the benchmark's own tests (CPU unless marked ``gpu``)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, never
    at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """``tiny(workload, nx=8, sensors=9)``: the resolved cell cut to ``nx``
    axial cells and ``sensors`` sensors, for the CPU. The mesh's geometry
    gaps are O(h^2), so their limits grow by (cell's nx / nx)^2."""
    from fusbench import cell

    def cut(workload: str, nx: int = 8, sensors: int = 9) -> dict:
        c = copy.deepcopy(cell.resolve(workload))
        scale = (c["config"]["nx"] / nx) ** 2
        c["config"]["nx"] = nx
        c["config"]["sensors"]["count"] = sensors
        limits = c["traffic"]["limits"]
        for name in ("mesh_volume_gap", "cap_area_gap"):
            if name in limits:
                limits[name] *= scale
        return c

    return cut
