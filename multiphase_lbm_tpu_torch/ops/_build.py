"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file of the package is compiled for Hopper (``sm_90a``)
into one shared library with a plain C interface,
``multiphase_lbm_tpu_torch/_build/libmlbm_kernels.so``, the first time a
kernel is needed, and again only when a source is newer than the library.
The library links no PyTorch headers, so a build takes seconds (a
``torch.utils.cpp_extension`` build takes minutes).  Nothing here runs at
import time: the CPU-only tests import every module of the package.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libmlbm_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
# nvcc's report of the last build (ptxas registers / spills per kernel)
# and its wall time in seconds; None until this process has built
build_log = None
build_seconds = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda/bin)")


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in sources())


def build() -> Path:
    """Compile the library if it is missing or older than a source."""
    global build_log, build_seconds
    if not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, LIB_PATH)
    build_seconds = time.perf_counter() - t0
    build_log = r.stdout + r.stderr
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every C entry point's
    argument and return types declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("sc_step_f32", "sc_step_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp, vp]
        fn.restype = i32
    lib.sc_error_string.argtypes = [i32]
    lib.sc_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
