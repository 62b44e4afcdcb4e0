"""Legacy-ASCII VTK writer, schema-identical to the reference modules.

A port of ``multiphase_lbm_tpu/io/vtk.py``.  Reproduces the exact
STRUCTURED_POINTS layout of e.g. ``saveVtkFields_Laplace2D``
(laplace2D.h:319-365): header, DIMENSIONS nx ny nz, ORIGIN/SPACING,
POINT_DATA, then per-field ``SCALARS <name> float 1`` / ``SCALARS <name> int
1`` / ``VECTORS <name> float`` blocks with x-fastest row ordering.  Fields
are numpy arrays; the driver copies device tensors to the host before they
reach this module.

Each field block becomes ASCII in one call of a hand-written C formatter,
``io/native/vtkfmt.c``, through ``ctypes``, which releases the interpreter
lock for the call, so the driver thread runs on while the writer thread
formats.  A float renders as Python's ``"%g"`` of its float32 cast (C++
``operator<<(float)``: 6 significant digits, no trailing zeros; ``nan``
whatever its sign), an int as ``"%d"`` of its int64.
``VtkWriter._render`` sizes one buffer for the whole file from
``TOKEN_BYTES``, the formatter writes each block into it, and
:meth:`VtkWriter.write` hands the buffer to the file in one write.
:func:`load_formatter` builds the library with the host C compiler
(``$CC``, else ``cc``; ``-O2 -shared -fPIC``) into the package's ``_build/``
at a process's first dump, and again only when the source is newer; a build
or load that fails raises ``RuntimeError`` with the compiler's message.  The
load is a ``library.load`` phase (``lib="vtkfmt"``), with ``library.build``
inside it when the compiler runs (``utils/profiling.phase``).
:meth:`VtkWriter.reference_dumps`, the numpy rendering the C formatter
replaced, is the plain reference the tests hold it to.  Each block adds its
count of formatted values (a vector's three a point) to the counter
``vtk.values.native``.
"""
from __future__ import annotations

import ctypes
import io
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..utils.profiling import count, phase, span

_SRC = Path(__file__).resolve().parent / "native" / "vtkfmt.c"
LIB_PATH = Path(__file__).resolve().parents[1] / "_build" / "libvtkfmt.so"

# the most bytes one value of a block (a vector's: one point) can take,
# separators included: a float32 "%g" token is at most 12 characters
# ("-3.40282e+38"), an int64 "%d" at most 20; a scalar row adds a newline
TOKEN_BYTES = {"float": 13, "int": 21, "vector": 39}

_lib = None
_lib_lock = threading.Lock()


def _build_formatter() -> Path:
    """Compile ``native/vtkfmt.c`` unless the library is newer than it.  The
    compiler writes to a name of this process and thread, renamed into
    place, so that concurrent builds never load a partial file."""
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
        return LIB_PATH
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(
        f".{LIB_PATH.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.environ.get("CC", "cc"), "-O2", "-shared", "-fPIC", str(_SRC),
           "-o", str(tmp)]
    try:
        with phase("library.build", lib="vtkfmt"):
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the VTK formatter cannot be built: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the VTK formatter failed to build "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load_formatter() -> ctypes.CDLL:
    """The formatter library, built on first use, with its three entries'
    argument and return types declared."""
    global _lib
    with _lib_lock:
        if _lib is None:
            with phase("library.load", lib="vtkfmt"):
                _lib = _load_formatter()
    return _lib


def _load_formatter() -> ctypes.CDLL:
    """Build if stale, load, and declare the entries' types."""
    path = _build_formatter()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(
            f"the VTK formatter {path} cannot be loaded: {e}") from e
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    # values, [f64,] n, row_len (vectors: ncomp), out, cap
    for name, args in (("vtk_format_float", [vp, ci, cl, cl, vp, cl]),
                       ("vtk_format_int", [vp, cl, cl, vp, cl]),
                       ("vtk_format_vector", [vp, ci, cl, cl, vp, cl])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = cl
    return lib


def _block_bytes(kind: str, arr: np.ndarray, nx: int) -> int:
    """The most bytes a block's values can take: ``TOKEN_BYTES`` a value
    (a vector's: a point), and a scalar row's newline."""
    if kind == "vector":
        if arr.shape[0] not in (2, 3):
            raise ValueError(f"a VTK vector has 2 or 3 components, "
                             f"not {arr.shape[0]}")
        return TOKEN_BYTES[kind] * (arr.size // arr.shape[0])
    return TOKEN_BYTES[kind] * arr.size + arr.reshape(-1, nx).shape[0]


def _float_values(arr: np.ndarray):
    """``arr`` C-contiguous as float32, or as float64 that the C formatter
    casts to float32 itself; and the formatter's ``f64`` flag."""
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float32)
    arr = np.ascontiguousarray(arr)
    return arr, int(arr.dtype == np.float64)


def _format_block(lib, kind: str, arr: np.ndarray, nx: int, out: int,
                  cap: int) -> int:
    """One block's values as ASCII at address ``out``, which holds ``cap``
    bytes, by one C call; returns the bytes written."""
    if kind == "vector":
        comps = arr.reshape(arr.shape[0], -1)
        vals, f64 = _float_values(comps)
        n = comps.shape[1]
        values = 3 * n
        size = lib.vtk_format_vector(vals.ctypes.data, f64, n, comps.shape[0],
                                     out, cap)
    elif kind == "int":
        vals = np.ascontiguousarray(arr.astype(np.int64, copy=False))
        values = vals.size
        size = lib.vtk_format_int(vals.ctypes.data, values, nx, out, cap)
    else:
        vals, f64 = _float_values(arr)
        values = vals.size
        size = lib.vtk_format_float(vals.ctypes.data, f64, values, nx, out, cap)
    if size < 0:
        raise RuntimeError(f"the VTK formatter's {cap}-byte buffer is too "
                           f"small for a {kind} block of {values} values")
    count("vtk.values.native", values)
    return size


def _fmt_floats(a: np.ndarray) -> np.ndarray:
    """Format float array like C++ ``operator<<(float)`` (6 significant
    digits, no trailing zeros)."""
    return np.char.mod("%g", a.astype(np.float32))


def _reference_body(kind: str, arr: np.ndarray, nx: int) -> bytes:
    """The plain numpy rendering of one block's values."""
    out = io.StringIO()
    if kind == "vector":
        comps = arr.reshape(arr.shape[0], -1)
        if comps.shape[0] == 2:
            comps = np.vstack([comps, np.zeros_like(comps[0])])
        cols = [_fmt_floats(cmp) for cmp in comps]
        for i in range(comps.shape[1]):
            out.write(f"{cols[0][i]} {cols[1][i]} {cols[2][i]}\n")
    else:
        rows = arr.reshape(-1, nx)
        if kind == "int":
            srows = np.char.mod("%d", rows.astype(np.int64))
        else:
            srows = _fmt_floats(rows)
        for r in srows:
            out.write(" ".join(r))
            out.write(" \n")
    return out.getvalue().encode("ascii")


class VtkWriter:
    """Accumulate named fields and serialise one legacy-VTK file.

    Fields are given as 2D ``(ny, nx)`` or 3D ``(nz, ny, nx)`` arrays;
    vectors as ``(d, ...)`` component-first, d 2 (written with a z of 0) or
    3.
    """

    def __init__(self, nx: int, ny: int, nz: int = 1, spacing: float = 1.0,
                 iteration: int = 0):
        self.nx, self.ny, self.nz = nx, ny, nz
        self.spacing = spacing
        self.iteration = iteration
        self._fields: List[Tuple[str, str, np.ndarray]] = []

    def scalar(self, name: str, data, as_int: bool = False):
        arr = np.asarray(data)
        self._fields.append((name, "int" if as_int else "float", arr))
        return self

    def vector(self, name: str, data):
        arr = np.asarray(data)
        self._fields.append((name, "vector", arr))
        return self

    # ── serialisation ──
    def _header(self) -> bytes:
        s = self.spacing
        return (f"# vtk DataFile Version 2.0\n"
                f"iteration {self.iteration}\nASCII\n\n"
                f"DATASET STRUCTURED_POINTS\n"
                f"DIMENSIONS {self.nx} {self.ny} {self.nz}\n"
                f"ORIGIN 0 0 0\n"
                f"SPACING {s:g} {s:g} {s:g}\n\n"
                f"POINT_DATA {self.nx * self.ny * self.nz}\n").encode()

    def _blocks(self):
        """Each field's header line(s), kind and values."""
        for name, kind, arr in self._fields:
            if kind == "vector":
                head = f"VECTORS {name} float\n"
            else:
                head = f"SCALARS {name} {kind} 1\nLOOKUP_TABLE default\n"
            yield head.encode(), kind, arr

    def _render(self) -> np.ndarray:
        """The file's bytes, a uint8 array: one buffer sized from
        ``TOKEN_BYTES``, each block's values written into it by one call of
        the C formatter, each followed by a blank line."""
        lib = load_formatter()
        blocks = list(self._blocks())
        caps = [_block_bytes(kind, arr, self.nx) for _, kind, arr in blocks]
        header = self._header()
        buf = np.empty(len(header) + sum(len(head) + 1 for head, _, _ in blocks)
                       + sum(caps), np.uint8)

        def put(pos, text):
            buf[pos:pos + len(text)] = np.frombuffer(text, np.uint8)
            return pos + len(text)

        pos = put(0, header)
        for (head, kind, arr), cap in zip(blocks, caps):
            pos = put(pos, head)
            pos += _format_block(lib, kind, arr, self.nx,
                                 buf.ctypes.data + pos, cap)
            pos = put(pos, b"\n")
        return buf[:pos]

    def dumps(self) -> str:
        return self._render().tobytes().decode("ascii")

    def reference_dumps(self) -> str:
        """:meth:`dumps` by the plain numpy formatter (the tests' reference)."""
        parts = [self._header()]
        for head, kind, arr in self._blocks():
            parts += [head, _reference_body(kind, arr, self.nx), b"\n"]
        return b"".join(parts).decode("ascii")

    def write(self, path):
        with span("vtk.format"):
            data = self._render()
        with span("vtk.disk"), open(path, "wb") as f:
            f.write(data)


def sol_filename(time_iter: int, prefix: str = "sol") -> str:
    """``sol_0001234.vtk`` naming, reference e.g. laplace2D.h:323."""
    return f"{prefix}_{time_iter:07d}.vtk"


def read_vtk_fields(path) -> dict:
    """Minimal legacy-VTK reader for golden/regression tests: returns
    {name: ndarray} for SCALARS/VECTORS blocks plus 'DIMENSIONS'."""
    text = Path(path).read_text().split()
    fields = {}
    dims = None
    i = 0
    n = len(text)
    while i < n:
        tok = text[i]
        if tok == "DIMENSIONS":
            dims = (int(text[i + 1]), int(text[i + 2]), int(text[i + 3]))
            i += 4
        elif tok == "SCALARS":
            name = text[i + 1]
            npts = dims[0] * dims[1] * dims[2]
            j = i + 4  # skip: SCALARS <name> <type> <ncomp>
            if text[j] == "LOOKUP_TABLE":
                j += 2
            vals = np.array([float(v) for v in text[j:j + npts]])
            fields[name] = vals.reshape(dims[2] * dims[1], dims[0])
            i = j + npts
        elif tok == "VECTORS":
            name = text[i + 1]
            npts = dims[0] * dims[1] * dims[2]
            j = i + 3
            vals = np.array([float(v) for v in text[j:j + 3 * npts]])
            fields[name] = vals.reshape(npts, 3)
            i = j + 3 * npts
        else:
            i += 1
    fields["DIMENSIONS"] = dims
    return fields
