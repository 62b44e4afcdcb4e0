"""The reference's combustion flow-field restart file (``ini_f.dat``).

Port of the reference-compatible half of
``multiphase_lbm_tpu/io/checkpoint.py`` (``save_converged_f_solution`` /
``Einlesefunktion_F``, ``CooLBM_MRT_combustion.cpp:3129-3178``): header
``nx ny q``, then one line of q values per cell, x-major outer, y inner, k
innermost per line.  The file interchanges converged flow fields with the
C++ and with the JAX package.  Full-state checkpoints (``save_state``,
``load_state``) use jax tree utilities there and are not ported yet
(ROADMAP Queue A item 11).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def save_flow_field_txt(path, f, precision: int = 15):
    """Write flow populations ``(q, ny, nx)`` (a tensor or an array) in the
    reference's restart layout."""
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    f = np.asarray(f)
    q, ny, nx = f.shape
    with open(path, "w") as fh:
        fh.write(f"{nx} {ny} {q}\n")
        for x in range(nx):
            for y in range(ny):
                fh.write(" ".join(f"{f[k, y, x]:.{precision}g}"
                                  for k in range(q)) + " \n")
            fh.write("\n")


def load_flow_field_txt(path, q=9, dtype=np.float64):
    """Read the reference restart file: whitespace tokens after the
    ``nx ny q`` header, cell-major x then y, k inner.  Returns a numpy
    array ``(q, ny, nx)``."""
    tokens = Path(path).read_text().split()
    nx, ny, qf = int(tokens[0]), int(tokens[1]), int(tokens[2])
    if qf != q:
        raise ValueError(f"{path} holds {qf} populations per cell, not {q}")
    vals = np.array(tokens[3:3 + nx * ny * q], dtype=dtype)
    return vals.reshape(nx, ny, q).transpose(2, 1, 0)
