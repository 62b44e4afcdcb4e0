"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file of the package is compiled for Hopper (``sm_90a``)
into one shared library with a plain C interface,
``multiphase_lbm_tpu_torch/_build/libmlbm_kernels.so``, the first time a
kernel is needed, and again only when a source is newer than the library.
Each source compiles in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links the objects.  The library links no PyTorch
headers, so a build takes seconds (a ``torch.utils.cpp_extension`` build
takes minutes).  Nothing here runs at import time: the CPU-only tests
import every module of the package.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry point -> argument types; every pointer and the stream as c_void_p
_VP, _I32 = ctypes.c_void_p, ctypes.c_int
ENTRY_POINTS = {
    # f, out, psi, mask, ny, nx, periodic, consts, stream
    "sc_step_f32": [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _VP, _VP],
    "sc_step_f64": [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _VP, _VP],
    # f, g, fo, go, phi, lap, mask, ny, nx, consts, stream
    "hcz_step_f32": [_VP] * 7 + [_I32, _I32, _VP, _VP],
    "hcz_step_f64": [_VP] * 7 + [_I32, _I32, _VP, _VP],
    # f, g, fo, go, phi, lap, P, nz, ny, nx, consts, stream
    "hcz3d_step_f32": [_VP] * 7 + [_I32, _I32, _I32, _VP, _VP],
    "hcz3d_step_f64": [_VP] * 7 + [_I32, _I32, _I32, _VP, _VP],
    # h, g, u, ho, go, uo, phi, ny, nx, fresh_phi, consts, stream
    "fakhari_step_f32": [_VP] * 7 + [_I32, _I32, _I32, _VP, _VP],
    "fakhari_step_f64": [_VP] * 7 + [_I32, _I32, _I32, _VP, _VP],
    # f, out, psi, ny, nx, consts, stream
    "scrt_step_f32": [_VP, _VP, _VP, _I32, _I32, _VP, _VP],
    "scrt_step_f64": [_VP, _VP, _VP, _I32, _I32, _VP, _VP],
    # gc, gs, mac, yr, gc_o, gs_o, mac_o, yr_o, bz_idx, bz_val, rs_idx,
    # rs_val, ctr, ny, nx, cap, t, par, consts, stream
    "pulsatile_step_f32": [_VP] * 13 + [_I32] * 5 + [_VP, _VP],
    "pulsatile_step_f64": [_VP] * 13 + [_I32] * 5 + [_VP, _VP],
    # a, b, flags, ckn, fs_col, fs_row, mats, fld, scratch, ny, nx, n_steps,
    # first_mode, consts, stream
    "combustion_run_f32": [_VP] * 9 + [_I32] * 4 + [_VP, _VP],
    "combustion_run_f64": [_VP] * 9 + [_I32] * 4 + [_VP, _VP],
}

# extra nvcc flags of one source: the pulsatile kernel rounds every multiply
# and add on its own, as the plain path does (see its header note)
SOURCE_FLAGS = {"pulsatile_step": ["-fmad=false"]}

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


def _run_all(cmds):
    """Start every command at once; wait for all; raise on the first that
    failed.  Returns their combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = []
    failed = None
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate(timeout=600)
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    return "".join(logs)


def build() -> Path:
    """Compile the library if it is missing or older than a source."""
    global build_log, build_seconds
    if not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [BUILD_DIR / f".{s.stem}.{tag}.o" for s in sources()]
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{tag}.tmp"
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(s.stem, []),
                         "-c", "-o", str(o), str(s)]
                        for s, o in zip(sources(), objs)])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, LIB_PATH)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = log
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every C entry point's
    argument and return types declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I32
    lib.sc_error_string.argtypes = [_I32]
    lib.sc_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
