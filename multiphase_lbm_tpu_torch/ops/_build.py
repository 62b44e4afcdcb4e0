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

:func:`enqueue` is the one way the kernel wrappers (``ops/*_fused.py``) call
the library: the ``kernel.enqueue`` span, the tensor's device, the symbol
of its dtype, the current stream, the error check and the launch counters.
The library's load (``library.load``, with ``library.build`` inside it when
nvcc runs) and each entry point's first C call in the process
(``kernel.first``) are recorded as phases (``utils/profiling.phase``).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils.profiling import count_launches, phase, span

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libmlbm_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry point stem -> argument types, alike for its ``_f32`` and ``_f64``
# entries; every pointer and the stream (the last) as c_void_p
_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # f, a, b, mask, ny, nx, periodic, n_steps, consts, stream
    "sc_step": [_VP] * 4 + [_I32] * 4 + [_VP, _VP],
    # f, g, fa, ga, fb, gb, mask, ny, nx, n_steps, consts, stream
    "hcz_step": [_VP] * 7 + [_I32] * 3 + [_VP, _VP],
    # f, g, mask, ws, out, ny, nx, consts, phi_mid, stream
    "hcz_record": [_VP] * 5 + [_I32] * 2 + [_VP, ctypes.c_double, _VP],
    # f, g, fa, ga, fb, gb, phi, nz, ny, nx, n_steps, consts, stream
    "hcz3d_step": [_VP] * 7 + [_I32] * 4 + [_VP, _VP],
    # f, g, phi, ws, out, nz, ny, nx, consts, stream
    "hcz3d_record": [_VP] * 5 + [_I32] * 3 + [_VP, _VP],
    # h, g, u, ho, go, uo, ny, nx, mode, consts, stream
    "fakhari_step": [_VP] * 6 + [_I32] * 3 + [_VP, _VP],
    # f, out, psi, ny, nx, consts, stream
    "scrt_step": [_VP, _VP, _VP, _I32, _I32, _VP, _VP],
    # f, psi, ws, out, ny, nx, consts, rho_cut, stream
    "scrt_record": [_VP] * 4 + [_I32] * 2 + [_VP, ctypes.c_double, _VP],
    # gc, gs, mac, yr, then gc, gs, mac, yr of buffer sets a and b, bz_idx,
    # bz_val, rs_idx, rs_val, ctr, ny, nx, cap, n_steps, t0, consts, stream
    "pulsatile_run": [_VP] * 17 + [_I32] * 5 + [_VP, _VP],
    # yr, yr_new, map, ny, nx, consts, stream
    "pulsatile_fresh_map": [_VP] * 3 + [_I32] * 2 + [_VP, _VP],
    # a, b, flags, ckn, fs_col, fs_row, fld, side, ny, nx, row0, ny_glob,
    # n_steps, first_mode, consts, stream
    "combustion_run": [_VP] * 8 + [_I32] * 6 + [_VP, _VP],
}
# C entry point -> argument types
ENTRY_POINTS = {f"{stem}_{kind}": argtypes
                for stem, argtypes in _SIGNATURES.items()
                for kind in ("f32", "f64")}

# extra nvcc flags of one source: the pulsatile kernel rounds every multiply
# and add on its own, as the plain path does (see its header note)
SOURCE_FLAGS = {"pulsatile_step": ["-fmad=false"]}

_lib = None
# nvcc's report of the last build (ptxas registers / spills per kernel);
# None until this process has built
build_log = None
# the symbols (entry and dtype) this process has called once
_called = set()


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
    """Compile the library if it is missing or older than a source, inside
    a ``library.build`` phase."""
    global build_log
    if not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [BUILD_DIR / f".{s.stem}.{tag}.o" for s in sources()]
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{tag}.tmp"
    with phase("library.build", lib="kernels"):
        try:
            log = _run_all([[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(s.stem, []),
                             "-c", "-o", str(o), str(s)]
                            for s, o in zip(sources(), objs)])
            log += _run_all([[nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)]])
            os.replace(tmp, LIB_PATH)
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
    build_log = log
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every C entry point's
    argument and return types declared; the first call of a process runs
    inside a ``library.load`` phase."""
    global _lib
    if _lib is not None:
        return _lib
    with phase("library.load", lib="kernels"):
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I32
        lib.sc_error_string.argtypes = [_I32]
        lib.sc_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def enqueue(family: str, entry: str, like: torch.Tensor, steps: int,
            launches: int, calls, halo: bool = False):
    """Call the C entry ``<entry>_f32`` or ``<entry>_f64`` (by ``like``'s
    dtype) once for each argument tuple of ``calls``, with the current
    stream of ``like``'s CUDA device appended::

        enqueue(FAMILY, "sc_step", f, n, n * LAUNCHES_PER_STEP,
                [(f.data_ptr(), ..., ctypes.addressof(consts))])

    The calls run inside the ``kernel.enqueue`` span (``family``,
    ``steps``), with ``like``'s device current: the library's runtime
    launches into the context current on the calling thread.  A call that
    returns an error raises ``RuntimeError``; when all have returned 0,
    ``steps`` and ``launches`` are counted under ``family`` (``.halo``
    after it for the halo-in entries; :func:`..utils.profiling.
    count_launches`).  ``calls`` may be a generator: a wrapper that loops
    its steps in Python forms each step's arguments as the loop reaches
    it.  The process's first call of a symbol runs inside a
    ``kernel.first`` phase (``family``, ``entry``: the symbol): the
    library's runtime loads the kernel's module there."""
    with span("kernel.enqueue", family=family, steps=steps), \
            torch.cuda.device(like.device):
        lib = load()
        symbol = entry + ("_f32" if like.dtype == torch.float32 else "_f64")
        fn = getattr(lib, symbol)
        stream = torch.cuda.current_stream(like.device).cuda_stream
        for args in calls:
            if symbol in _called:
                err = fn(*args, stream)
            else:
                with phase("kernel.first", family=family, entry=symbol):
                    err = fn(*args, stream)
                _called.add(symbol)
            if err != 0:
                raise RuntimeError(f"{entry} launch failed: "
                                   + lib.sc_error_string(err).decode())
    count_launches(family, steps, launches, halo)
