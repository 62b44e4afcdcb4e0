"""The combustion channel against the capture of the C++ reference.

The capture ``multiphase_lbm_tpu/validation/data/combustion_reference.npz``
holds the six VTK fields of an instrumented build of
``CooLBM_MRT_combustion.cpp`` at 128 × 48 (Density, Temperature,
mass_fraction_O2, mass_fraction_CO2, velocity_X, velocity_Y) every 100
steps to 500, and its flags (capture protocol: BASELINE.md).  It is read by
path, as data: nothing of the JAX package is imported.  The gate is that of
``tests/test_combustion_parity.py``: every field within its tolerance at
the reference's float print precision, over the bulk cells (and the
obstacle for Temperature), at steps 100 to 500, in the shipped binary's
mode, where ``first_step`` is never cleared, so the LI2014 conjugate fix
never runs (:func:`..ops.combustion_fused.run_fused` with
``all_first_steps``).

    python -m multiphase_lbm_tpu_torch.validation.combustion_reference [--device cuda|cpu] [--f32]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..models import combustion as cbm
from ..ops import combustion_fused

CAPTURE = (Path(__file__).resolve().parents[2] / "multiphase_lbm_tpu"
           / "validation" / "data" / "combustion_reference.npz")
# field → (absolute tolerance at the reference's float print precision,
#          compared over obstacle cells too)
FIELDS = {
    "Density": (1e-5, False),
    "velocity_X": (1e-6, False),
    "velocity_Y": (1e-6, False),
    "Temperature": (1e-5, True),
    "mass_fraction_O2": (2e-6, False),
    "mass_fraction_CO2": (2e-6, False),
}
STEPS = (100, 200, 300, 400, 500)
NX, NY = 128, 48


def compare(*, device, dtype=torch.float64):
    """Run the 128 × 48 channel through :func:`..ops.combustion_fused
    .run_fused` on ``device`` (the kernel on a card, the plain path on the
    CPU) and return, for each of :data:`STEPS`, the largest deviation of
    each field of :data:`FIELDS` from the capture over its cells."""
    cap = np.load(CAPTURE)
    bulk = cap["flag"] == 0
    obst = cap["flag"] == 2
    p = cbm.CombustionParams(nx=NX, ny=NY)
    flags, _ = cbm.build_geometry(p)
    st = cbm.initialize(p, dtype, flags=flags, device=device)
    rows, it = {}, 0
    for tgt in STEPS:
        st = combustion_fused.run_fused(st, p, tgt - it, all_first_steps=True)
        it = tgt
        rho, u = cbm.macro_flow(st.f)
        ours = {"Density": rho, "velocity_X": u[0], "velocity_Y": u[1],
                "Temperature": cbm.macro_scalar(st.gT),
                "mass_fraction_O2": cbm.macro_scalar(st.gO2),
                "mass_fraction_CO2": cbm.macro_scalar(st.gCO2)}
        row = {}
        for name, (_, with_obst) in FIELDS.items():
            sel = bulk | obst if with_obst else bulk
            a = ours[name].double().cpu().numpy()
            row[name] = float(np.abs(a - cap[f"{name}_{tgt}"])[sel].max())
        rows[tgt] = row
    return rows


def within(rows) -> bool:
    """Every field of every row within its :data:`FIELDS` tolerance."""
    return all(row[name] < FIELDS[name][0]
               for row in rows.values() for name in FIELDS)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="combustion_reference")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f32", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("combustion_reference: no CUDA device is visible; pass "
              "--device cpu for the plain path", file=sys.stderr)
        return 2
    dtype = torch.float32 if args.f32 else torch.float64
    rows = compare(device=device, dtype=dtype)
    for step, row in rows.items():
        print(f"step {step}: " + ", ".join(
            f"{k} {v:.3e} (< {FIELDS[k][0]:g})" for k, v in row.items()))
    ok = within(rows)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
