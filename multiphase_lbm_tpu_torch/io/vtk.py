"""Legacy-ASCII VTK writer, schema-identical to the reference modules.

A copy of ``multiphase_lbm_tpu/io/vtk.py`` with its numpy formatter only
(the JAX package's optional C formatter, ``io/native/``, writes the same
bytes and is not ported yet).  Reproduces the exact STRUCTURED_POINTS
layout of e.g. ``saveVtkFields_Laplace2D`` (laplace2D.h:319-365): header,
DIMENSIONS nx ny nz, ORIGIN/SPACING, POINT_DATA, then per-field
``SCALARS <name> float 1`` / ``SCALARS <name> int 1`` / ``VECTORS <name>
float`` blocks with x-fastest row ordering.  Fields are numpy arrays; the
driver copies device tensors to the host before they reach this module.
"""
from __future__ import annotations

import io
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..utils.profiling import span


def _fmt_floats(a: np.ndarray) -> np.ndarray:
    """Format float array like C++ ``operator<<(float)`` (6 significant
    digits, no trailing zeros)."""
    return np.char.mod("%g", a.astype(np.float32))


class VtkWriter:
    """Accumulate named fields and serialise one legacy-VTK file.

    Fields are given as 2D ``(ny, nx)`` or 3D ``(nz, ny, nx)`` arrays;
    vectors as ``(d, ...)`` component-first.
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
    def dumps(self) -> str:
        npts = self.nx * self.ny * self.nz
        out = io.StringIO()
        s = self.spacing
        out.write("# vtk DataFile Version 2.0\n")
        out.write(f"iteration {self.iteration}\nASCII\n\n")
        out.write("DATASET STRUCTURED_POINTS\n")
        out.write(f"DIMENSIONS {self.nx} {self.ny} {self.nz}\n")
        out.write("ORIGIN 0 0 0\n")
        out.write(f"SPACING {s:g} {s:g} {s:g}\n\n")
        out.write(f"POINT_DATA {npts}\n")
        for name, kind, arr in self._fields:
            if kind == "vector":
                out.write(f"VECTORS {name} float\n")
                comps = arr.reshape(arr.shape[0], -1)
                if comps.shape[0] == 2:
                    comps = np.vstack([comps, np.zeros_like(comps[0])])
                cols = [_fmt_floats(cmp) for cmp in comps]
                for i in range(comps.shape[1]):
                    out.write(f"{cols[0][i]} {cols[1][i]} {cols[2][i]}\n")
                out.write("\n")
            else:
                vtype = "int" if kind == "int" else "float"
                out.write(f"SCALARS {name} {vtype} 1\nLOOKUP_TABLE default\n")
                rows = arr.reshape(-1, self.nx)
                if kind == "int":
                    srows = np.char.mod("%d", rows.astype(np.int64))
                else:
                    srows = _fmt_floats(rows)
                for r in srows:
                    out.write(" ".join(r))
                    out.write(" \n")
                out.write("\n")
        return out.getvalue()

    def write(self, path):
        with span("vtk.format"):
            text = self.dumps()
        with span("vtk.disk"):
            Path(path).write_text(text)


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
