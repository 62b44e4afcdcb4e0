"""Analytic channel-flow validation: steady Poiseuille and oscillatory
Womersley profiles against closed-form solutions.

Port of ``multiphase_lbm_tpu/validation/womersley.py``.  Two gates:

* the core D2Q9 stack (:func:`run_validation`): a body-force-driven channel
  (periodic x, on-site bounce-back walls, MRT with a uniform relaxation
  diagonal, Guo forcing) under ``F(t) = F₀ + A·sin(ωt)``, against the steady
  parabola and the Womersley profile, from one beat's Fourier transform
  after the viscous transient;
* the pulsatile module's quirk-free rigid channel
  (:func:`run_module_validation`, 61 × 24): the steady Poiseuille profile,
  the Womersley profile shape, and closure of the fundamental-mode momentum
  budget, through the module's own Zou/He pressure waveforms and Bouzidi
  walls (see the JAX module for the findings behind ``MODULE_GATES``).

Both run on ``device`` (default ``cuda``) through the plain PyTorch path:
the pulsatile kernel implements the parity mode only.  The JAX module's
``_self_configure`` (a platform pin for its backend) has no counterpart.

    python -m multiphase_lbm_tpu_torch.validation.womersley [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core import collision as coll
from ..core import streaming as strm
from ..core.lattice import D2Q9
from ..models import pulsatile as pm


def run_channel(ny=34, nx=8, tau=0.65, F0=1e-6, A=1e-6, t_beat=1287,
                dtype=torch.float64, device="cuda"):
    """Force-driven channel: returns (y, fluid-row mask, u_xt of shape
    (t_beat, ny) covering the final beat, wall half-positions (ym, h),
    n_settle)."""
    device = torch.device(device)
    omega_lb = 1.0 / tau
    w, c = coll.lattice_tensors(D2Q9, torch.zeros((), dtype=dtype,
                                                  device=device))
    S = np.full(9, omega_lb)
    fluid = torch.ones((ny, nx), dtype=torch.bool, device=device)
    fluid[0] = False
    fluid[-1] = False
    omega_t = 2.0 * np.pi / t_beat
    cx = c[:, 0, None, None]

    def force_at(t):
        return F0 + A * np.sin(omega_t * t)

    def macro(f, Fx):
        rho = f.sum(dim=0)
        mom = torch.einsum("kd,kyx->dyx", c, f)
        # Guo half-force shift; the wall rows carry rho = 0, so guard the
        # divide
        u = (mom + 0.5 * torch.stack([torch.full_like(rho, Fx),
                                      torch.zeros_like(rho)])) \
            / torch.where(rho > 0, rho, torch.ones_like(rho))
        return rho, u

    def step(f, t):
        Fx = force_at(t)
        rho, u = macro(f, Fx)
        feq = coll.equilibrium(rho, u, D2Q9)
        post = coll.mrt_collide(f, feq, S)
        cu = torch.einsum("kd,dyx->kyx", c, u)
        guo = ((1.0 - 0.5 * omega_lb) * w[:, None, None]
               * (3.0 * (cx - u[0][None]) + 9.0 * cu * cx) * Fx)
        post = torch.where(fluid[None], post + guo, f)
        return strm.stream_bounce_back(post, fluid, D2Q9)

    f = coll.equilibrium(torch.ones((ny, nx), dtype=dtype, device=device),
                         torch.zeros((2, ny, nx), dtype=dtype, device=device),
                         D2Q9)
    nu = (tau - 0.5) / 3.0
    h = (ny - 2) / 2.0
    # 8 time constants of the slowest viscous mode, then one beat
    n_settle = int(8 * 4 * h * h / (nu * np.pi ** 2)) + t_beat
    for t in range(n_settle):
        f = step(f, t)
    u_xt = []
    for t in range(n_settle, n_settle + t_beat):
        f = step(f, t)
        _, u = macro(f, force_at(t + 1))    # state after step t is at t+1
        u_xt.append(u[0, :, 0])
    y = np.arange(ny, dtype=float)
    m = fluid[:, 0].cpu().numpy()
    return (y, m, torch.stack(u_xt).cpu().numpy(), ((ny - 1) / 2.0, h),
            n_settle)


def analytic_profiles(y, ym, h, mu, rho, omega, F_mean, F_hat):
    u_steady = F_mean / (2.0 * mu) * (h * h - (y - ym) ** 2)
    lam = np.sqrt(1j * rho * omega / mu)
    u_hat = (F_hat / (1j * rho * omega)) * (
        1.0 - np.cosh(lam * (y - ym)) / np.cosh(lam * h))
    return u_steady, u_hat


def run_validation(ny=34, tau=0.65, F0=1e-6, A=1e-6, t_beat=1287,
                   verbose=True, device="cuda"):
    """(steady, oscillatory) relative errors of the core-stack channel."""
    y, m, u_xt, (ym, h), n_settle = run_channel(ny=ny, tau=tau, F0=F0, A=A,
                                                t_beat=t_beat, device=device)
    nu = (tau - 0.5) / 3.0
    mu = nu  # rho = 1
    omega = 2.0 * np.pi / t_beat
    t = np.arange(t_beat) + n_settle + 1
    ph = np.exp(-1j * omega * t)
    u_mean = u_xt.mean(axis=0)
    u_hat = 2.0 / t_beat * (u_xt * ph[:, None]).sum(axis=0)
    F_t = F0 + A * np.sin(omega * t)
    F_mean = float(F_t.mean())
    F_hat = complex(2.0 / t_beat * np.sum(F_t * ph))

    ua_steady, ua_hat = analytic_profiles(y, ym, h, mu, 1.0, omega,
                                          F_mean, F_hat)
    err_s = float(np.abs(u_mean[m] - ua_steady[m]).max()
                  / np.abs(ua_steady[m]).max())
    err_o = float(np.abs(u_hat[m] - ua_hat[m]).max()
                  / np.abs(ua_hat[m]).max())
    if verbose:
        Wo = h * np.sqrt(omega / nu)
        print(f"channel ny={ny}, h={h}, tau={tau}, Wo={Wo:.2f}, "
              f"delta={np.sqrt(2 * nu / omega):.2f} cells")
        print(f"steady Poiseuille profile rel err = {err_s:.5f}")
        print(f"Womersley oscillatory profile rel err = {err_o:.5f}")
    return err_s, err_o


# the JAX module's gates (f64, ny=34, tau=0.65, Wo=5.0: measured steady
# 0.00098, oscillatory 0.00868 there)
GATE_STEADY = 0.003
GATE_OSC = 0.02


def run_module_channel(nx=61, ny=24, t_beat=400, wall=2.3,
                       dtype=torch.float64, device="cuda"):
    """The pulsatile module's rigid channel in the physics mode
    (``momentum_quirk=False``): one beat of the full (P, Ux, Uy) fields after
    ≥ 9 beats of settling, as host arrays of shape (t_beat, ny, nx)."""
    device = torch.device(device)
    p = pm.PulsatileParams(nx=nx, ny=ny, deformable=False, is_severed=False,
                           momentum_quirk=False, t_beat=t_beat)
    st = pm.initialize_rigid_channel(p, wall, ny - 1 - wall, dtype,
                                     device=device)
    nu = (p.tau - 0.5) / 3.0
    ym = (ny - 1) / 2.0
    h = (ny - 1 - 2 * wall) / 2.0
    n_settle = (p.t_start + p.t_propagation
                + int(8 * 4 * h * h / (nu * np.pi ** 2)))
    st = pm.run(st, 0, p, n_settle)
    fields = []
    for t in range(n_settle, n_settle + t_beat):
        st = pm.step(st, t, p)
        fields.append(torch.stack([st.P, st.Ux, st.Uy]))
    P, Ux, Uy = torch.stack(fields, dim=1).cpu().numpy()
    return P, Ux, Uy, (ym, h, nu), n_settle


# the JAX module's gates, ~2x its measured figures (61x24, t_beat=400,
# wall=2.3, f64: steady 0.0155, shape 0.072, budget residual 0.0945)
MODULE_GATES = {"steady": 0.04, "shape": 0.15, "budget": 0.20}


def run_module_validation(nx=61, ny=24, t_beat=400, wall=2.3, verbose=True,
                          device="cuda"):
    """Errors of the module's quirk-free mode: steady Poiseuille profile,
    Womersley profile shape and fundamental-mode momentum-budget closure,
    as a dict keyed like ``MODULE_GATES``."""
    P, Ux, Uy, (ym, h, nu), n_settle = run_module_channel(
        nx=nx, ny=ny, t_beat=t_beat, wall=wall, device=device)
    if not np.isfinite(Ux).all():
        raise RuntimeError("module channel went non-finite")
    omega = 2.0 * np.pi / t_beat
    t = np.arange(t_beat) + n_settle + 1
    ph = np.exp(-1j * omega * t)

    def fhat(a):
        return 2.0 / t_beat * (a * ph[:, None, None]).sum(axis=0)

    y = np.arange(ny, dtype=float)
    m = np.abs(y - ym) <= h - 0.5
    xc = nx // 2

    u_mean = Ux.mean(axis=0)
    G0 = float(np.gradient(P.mean(axis=0), axis=1)[6:ny - 6, 8:-8].mean())
    ua_s, _ = analytic_profiles(y, ym, h, nu, 1.0, omega, -G0, 0.0)
    err_steady = float(np.abs(u_mean[m, xc] - ua_s[m]).max()
                       / np.abs(ua_s[m]).max())

    u_hat = fhat(Ux)
    _, ua_h = analytic_profiles(y, ym, h, nu, 1.0, omega, 0.0, 1.0)
    shape_sim = u_hat[:, xc] / u_hat[ny // 2, xc]
    shape_ana = ua_h / ua_h[ny // 2]
    err_shape = float(np.abs(shape_sim[m] - shape_ana[m]).max())

    dudt = 1j * omega * fhat(Ux)
    Gx = fhat(np.gradient(P, axis=2))
    lap = fhat(np.gradient(np.gradient(Ux, axis=1), axis=1)
               + np.gradient(np.gradient(Ux, axis=2), axis=2))
    adv = fhat(Ux * np.gradient(Ux, axis=2) + Uy * np.gradient(Ux, axis=1))
    res = dudt + Gx - nu * lap + adv
    sl = (slice(6, ny - 6), slice(8, nx - 8))
    err_budget = float(np.abs(res[sl]).max() / np.abs(dudt[sl]).max())

    errs = {"steady": err_steady, "shape": err_shape, "budget": err_budget}
    if verbose:
        Wo = h * np.sqrt(omega / nu)
        print(f"module channel {nx}x{ny}, h={h}, Wo={Wo:.2f}, "
              f"beats covered={(n_settle + t_beat) / t_beat:.1f}")
        for k, v in errs.items():
            print(f"  {k}: {v:.4f} (gate {MODULE_GATES[k]})")
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser(prog="womersley")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("womersley: no CUDA device is visible; pass --device cpu",
              file=sys.stderr)
        return 2
    err_s, err_o = run_validation(device=args.device)
    ok = err_s < GATE_STEADY and err_o < GATE_OSC
    errs = run_module_validation(device=args.device)
    ok = ok and all(errs[k] < MODULE_GATES[k] for k in MODULE_GATES)
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
