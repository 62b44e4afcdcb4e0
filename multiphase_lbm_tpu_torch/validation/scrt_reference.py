"""The SC Rayleigh–Taylor run against the capture of the C++ reference.

The capture ``multiphase_lbm_tpu/validation/data/scrt_reference.npz`` holds
the density along the probe columns x = 0 and x = nx/2 of an instrumented
build of the reference (``RayleighTaylor2D.h`` with its shipped config,
N = 128 on the {N, 4N + 2} domain) at steps 250, 1000, 2000 and 3000, and
the reference's spike and bubble rows at 1000, 2000 and 3000 (capture
protocol: BASELINE.md).  It is read by path, as data: nothing of the JAX
package is imported.  The JAX package gates the probes at 250 steps to the
reference's float output precision (atol 5e-5,
tests/test_sc_variants.py) and measured 2.2e-5 over 1000 steps
(BASELINE.md:62-65); :data:`GATED_STEPS` are those two.  Later steps are
reported, not gated: no run of the JAX package has shown how close it stays
there.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..io.config import lb_parameters
from ..models import shan_chen_rt as rt
from ..ops import scrt_fused

CAPTURE = (Path(__file__).resolve().parents[2] / "multiphase_lbm_tpu"
           / "validation" / "data" / "scrt_reference.npz")
CAPTURED_STEPS = (250, 1000, 2000, 3000)
GATED_STEPS = (250, 1000)
ATOL = 5e-5
N = 128


def config_params(n: int = N) -> rt.SCRTParams:
    """``configs/sc_RayleighTaylor2D.txt`` physics at resolution ``n``
    (Re 30.72, u_lb 0.04: ω = 1 at N = 128)."""
    _, omega, _, _ = lb_parameters(0.04, n, 30.72)
    return rt.SCRTParams(omega=omega, rhol=1.2, rhog=0.4, g=-5.0,
                         gravity=-1.25e-5)


def compare(*, device, dtype=torch.float64, steps=CAPTURED_STEPS):
    """Run the N = 128 config through :func:`..ops.scrt_fused.run_fused` on
    ``device`` (the kernel on a card, the plain path on the CPU) and return,
    for each of ``steps``, a dict: the largest |Δρ| against the capture on
    each probe column's interior rows (``col0``, ``colmid``), the run's
    ``spike`` and ``bubble`` rows (:func:`..models.shan_chen_rt.interface_height`)
    and, where the capture has them, the reference's (``ref_spike``,
    ``ref_bubble``)."""
    data = np.load(CAPTURE)
    p = config_params()
    nx, ny = N, 4 * N + 2
    fluid = rt.geometry_channel(nx, ny, device=device)
    fluid_host = fluid.cpu().numpy()
    f = rt.init_interface(nx, ny, p, dtype=dtype, device=device) * fluid[None]
    out, it = {}, 0
    for s in sorted(steps):
        f = scrt_fused.run_fused(f, p, s - it)
        it = s
        rho = rt.density(f).double().cpu().numpy()
        row = {}
        for name, col in (("col0", 0), ("colmid", nx // 2)):
            ref = np.asarray(data[f"rho_{name}_{s}"], dtype=np.float64)
            row[name] = float(np.abs(rho[1:-1, col] - ref[1:-1]).max())
        row["spike"], row["bubble"] = rt.interface_height(rho, fluid_host, p)
        if f"spike_{s}" in data:
            row["ref_spike"] = int(data[f"spike_{s}"])
            row["ref_bubble"] = int(data[f"bubble_{s}"])
        out[s] = row
    return out
