"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a`` (Hopper), all started together, and the objects are linked into
one shared library with a plain C interface. The library is keyed by a hash
of the sources and flags and kept in ``_build/`` beside this file (listed in
``.gitignore``), so a second process reuses it. A missing ``nvcc``, a failed
compile or a failed load raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .analysis.timing import traced

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_hash(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run(procs) -> str:
    """Wait for every (command, process) pair, then raise on the first that
    failed; returns the joined compiler output."""
    results = [(cmd, proc, *proc.communicate()) for cmd, proc in procs]
    for cmd, proc, out, err in results:
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{out}{err}"
            )
    return "".join(out + err for _, _, out, err in results)


@traced("fus.setup.library")
def build() -> tuple[Path, float, str]:
    """Compile the kernels if no library for the current sources exists.

    Returns (library path, compile seconds (0 if reused), compiler log)."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / f"libfus_kernels_{_source_hash(sources + headers)}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = lib.with_name(f"{lib.name}.{tag}")
    t0 = time.perf_counter()
    try:
        compiles = []
        for src, obj in zip(sources, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        log = _run(compiles)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        log += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, lib)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)
    return lib, time.perf_counter() - t0, log


_P = ctypes.c_void_p
_I = ctypes.c_int
_U64P = ctypes.POINTER(ctypes.c_uint64)
_INTP = ctypes.POINTER(ctypes.c_int)
_LLP = ctypes.POINTER(ctypes.c_longlong)
_DP = ctypes.POINTER(ctypes.c_double)


@functools.cache
@traced("fus.setup.library")
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use) with its C signatures."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    # K1 and K2 take the tile plan (ops/stiffness.py::tile_plan) as 8 ints
    lib.fus_stiffness_apply.argtypes = [_I, _I, _U64P, _U64P, _INTP, _P, _LLP, _I, _DP, _INTP,
                                        _P, _I]
    # K4a and K4b, like K5a and K5b, take their plans
    # (ops/stiffness.py::column_plan, plane_plan) as 4 and 8 ints
    lib.fus_stiffness_axis0.argtypes = [_I, _I, _U64P, _U64P, _INTP, _P, _LLP, _I, _DP, _INTP,
                                        _P, _I]
    lib.fus_stiffness_axes12.argtypes = [_I, _I, _U64P, _U64P, _INTP, _P, _P, _LLP, _I, _DP,
                                         _INTP, _P, _I]
    # K2 also takes its band operand (null if absent) and its rows
    lib.fus_stage.argtypes = [_I, _I, _U64P, _INTP, _LLP, _I, _DP, _DP, _I, _I, _INTP, _P, _I,
                              _P, _I]
    lib.fus_stage_a.argtypes = [_I, _I, _U64P, _INTP, _LLP, _I, _DP, _DP, _INTP, _P, _I]
    lib.fus_stage_b.argtypes = [_I, _I, _U64P, _INTP, _LLP, _I, _DP, _DP, _I, _I, _INTP, _P,
                                _I]
    # K3 takes its plan (ops/step_wave.py::wave_plan) as 11 ints
    lib.fus_step_wave.argtypes = [_I, _I, _U64P, _INTP, _LLP, _I, _DP, _DP, _I, _I, _INTP, _P,
                                  _P, _P, _P, _I]
    for name in ("fus_stiffness_apply", "fus_stiffness_axis0", "fus_stiffness_axes12",
                 "fus_stage", "fus_stage_a", "fus_stage_b", "fus_step_wave"):
        getattr(lib, name).restype = _I
    lib.fus_error_string.argtypes = [_I]
    lib.fus_error_string.restype = ctypes.c_char_p
    return lib
