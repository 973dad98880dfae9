"""Native (C++) host geometry: the volume factors of large meshes, by ctypes.

``geometry.cpp`` is the JAX package's streaming volume-factor library,
copied: per cell and quadrature point, w·|det J| and the packed
G = w·|det J|·J⁻¹J⁻ᵀ, cell by cell with O(Nq·d²) scratch, over threads. It is
compiled by the host's ``g++`` at first use into ``_build/`` beside the
package (listed in ``.gitignore``), under a name keyed by a hash of the
source, the flags and the host CPU, so a second process reuses it.
The build writes a temporary file and renames it into place under a file
lock, so processes that load the library at the same moment all get it. A
missing ``g++``, a failed compile or a failed load raises: nothing falls
back to the numpy path unless ``FUS_NATIVE=0`` asks for it
(``core/geometry.py::quadrature_factors``).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "geometry.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def enabled() -> bool:
    """False when ``FUS_NATIVE=0`` (read at every call, as the JAX package
    reads the switch) asks for the numpy path."""
    return os.environ.get("FUS_NATIVE", "1") != "0"


def cxx_path() -> str:
    """The host C++ compiler, ``g++`` on PATH; raises if there is none."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: the native geometry library cannot be built "
                           "(FUS_NATIVE=0 selects the numpy path)")
    return path


def _host_cpu() -> str:
    """The host CPU's model and feature flags: ``-march=native`` builds for
    them, so a library built on another CPU is not reused."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.machine()
    keep = [ln for ln in text.splitlines() if ln.startswith(("model name", "flags"))]
    return "\n".join([platform.machine()] + keep[:2])


def build(build_dir: Path | None = None) -> Path:
    """Compile ``geometry.cpp`` unless a library of this source, these flags
    and this host CPU exists in ``build_dir`` (default ``BUILD_DIR``);
    returns its path."""
    build_dir = Path(build_dir or BUILD_DIR)
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu().encode())
    h.update(SOURCE.read_bytes())
    lib = build_dir / f"libfusgeom_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "libfusgeom.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while this one waited
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [cxx_path(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library (built on first use) with its C signature."""
    lib = ctypes.CDLL(str(build()))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.fus_volume_factors.restype = ctypes.c_int
    lib.fus_volume_factors.argtypes = [dp, dp, dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                       dp, dp, ctypes.c_int]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def volume_factors(verts: np.ndarray, qpts: np.ndarray, qwts: np.ndarray):
    """Geometry factors of the cells ``verts`` [Nc, 2^d, d] at the points
    ``qpts`` [Nq, d] with weights ``qwts`` [Nq]: (wdetJ [Nc, Nq],
    G [Nc, Nq, d(d+1)/2]), float64, over up to 16 threads."""
    lib = library()
    verts = np.ascontiguousarray(verts, np.float64)
    qpts = np.ascontiguousarray(qpts, np.float64)
    qwts = np.ascontiguousarray(qwts, np.float64)
    nc, nv, d = verts.shape
    nq = qpts.shape[0]
    if nv != 2**d or qpts.shape != (nq, d) or qwts.shape != (nq,):
        raise ValueError(f"volume_factors: shapes {verts.shape}, {qpts.shape}, {qwts.shape}")
    wdetJ = np.empty((nc, nq), np.float64)
    G = np.empty((nc, nq, d * (d + 1) // 2), np.float64)
    nthreads = min(os.cpu_count() or 1, 16)
    rc = lib.fus_volume_factors(_ptr(verts), _ptr(qpts), _ptr(qwts), nc, nq, d, _ptr(wdetJ),
                                _ptr(G), nthreads)
    if rc != 0:
        raise RuntimeError(f"fus_volume_factors returned {rc} (dim {d})")
    return wdetJ, G
