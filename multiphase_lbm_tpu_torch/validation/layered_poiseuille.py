"""Layered two-phase Poiseuille vs the piecewise-analytic Stokes profile.

Port of ``multiphase_lbm_tpu/validation/layered_poiseuille.py``.  The
reference validates its layered channel flows against analytical profiles
(README.md:113-115; SURVEY §4.2).  For a symmetric gas|liquid|gas channel
driven by a constant per-node body force Fx with equal kinematic viscosity
ν in both phases (same τ), the steady Stokes solution with no-slip walls
at y=0,H is

    τ_shear(y) = Fx (H/2 − y),   du/dy = τ_shear/μ(y),  μ = ρ(y) ν,

integrated from the wall.  The comparison uses the *measured* density
profile (the diffuse interface and SC equilibration shift the layer
densities), so it validates the momentum balance rather than the initial
condition.  PASS: max relative deviation below 0.25 (the diffuse interface,
w_int = 4, smears μ over ~8 cells, and the wall plane is half-way: the
sharp-interface solution is an upper-bound comparison).

The solver runs on ``device`` (default ``cuda``) through
:func:`..ops.sc_fused.run_fused`, so on the card through the Shan–Chen
kernel (constant-G ψ, per-node force), and on the CPU through the plain
path:

    python -m multiphase_lbm_tpu_torch.validation.layered_poiseuille \
        [steps] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ..models import shan_chen as sc
from ..ops import sc_fused

GATE = 0.25


def analytic_profile(rho_y, nu, Fx):
    """Integrate du/dy = Fx(H/2−y)/μ(y) from the bottom wall (half-way BB:
    wall plane at y=0.5 lattice units from the solid row)."""
    ny = rho_y.shape[0]
    yw0, yw1 = 0.5, ny - 1.5          # wall planes (half-way bounce-back)
    H = yw1 - yw0
    y = np.arange(ny, dtype=float)
    mu = rho_y * nu
    du = np.where((y > yw0) & (y < yw1), Fx * (yw0 + H / 2.0 - y) / mu, 0.0)
    u = np.cumsum(du)
    u -= u[1]                          # no-slip at the first fluid node-ish
    u[(y <= yw0) | (y >= yw1)] = 0.0
    return u


def run(n=64, steps=40000, dtype=torch.float64, gx=1e-6, device="cuda"):
    """``(prof, ana, err)``: the x-averaged velocity profile after
    ``steps`` steps of the ``n × n`` channel, the analytic profile of its
    measured densities, and their max relative deviation over the fluid
    rows."""
    device = torch.device(device)
    tau = 1.0
    p0 = sc.SCParams(omega=1.0 / tau, TT0=0.95, rhol=0.21, rhog=0.067,
                     rho_w=0.067, psi_mode="const_g", G=-1.0, gx_u=gx)
    p = dataclasses.replace(p0, p_shift=sc.compute_p_shift(p0))
    f = sc.init_layers(n, n, p, h_lower=0.3, w_int=4, dtype=dtype,
                       device=device)
    fluid = sc.geometry_channel_walls(n, n, device=device)
    f = sc.apply_geometry(f, fluid)
    f = sc_fused.run_fused(f, fluid.to(torch.float32), p, steps)

    rho = sc.density(f).cpu().numpy()
    u = sc.u_actual(f, fluid, p).cpu().numpy()
    # x-average: pseudopotential interfaces carry local spurious vortices an
    # order of magnitude above the weak drive; they cancel in the mean while
    # the Poiseuille profile survives
    prof = u[0].mean(axis=1)
    rho_y = rho.mean(axis=1)
    nu = (tau - 0.5) / 3.0
    ana = analytic_profile(rho_y, nu, p.gx_u)
    m = fluid.cpu().numpy()[:, n // 2]
    err = np.abs(prof[m] - ana[m]).max() / max(np.abs(ana[m]).max(), 1e-30)
    return prof, ana, err


def main(argv=None):
    ap = argparse.ArgumentParser(prog="layered_poiseuille")
    ap.add_argument("steps", nargs="?", type=int, default=40000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, the kernel) or cpu (the plain path)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("layered_poiseuille: no CUDA device is visible; pass --device "
              "cpu", file=sys.stderr)
        return 2
    prof, ana, err = run(steps=args.steps, device=args.device)
    print(f"max relative deviation from analytic profile: {err:.3f}")
    print("peak u sim/analytic:", prof[1:-1].max(), ana.max())
    ok = err < GATE
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
