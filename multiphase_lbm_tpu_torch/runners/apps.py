"""Per-problem drivers, schema-compatible with the reference app modules.

Port of the Shan–Chen drivers of ``multiphase_lbm_tpu/runners/apps.py``
(``run_sc_laplace2d``, ``run_sc_contact_angle``, ``_run_sc``).  Each reads
the reference's ``config_*.txt`` keys, runs the solver in chunks of the
output cadence and emits the same observables: ``sol_*.vtk`` with the
module's field list, ``energy.dat`` / ``mass.dat`` / ``contact_angle.dat``
and the final MLUPS line.  State on a CUDA device advances through the
fused kernel (:func:`..ops.sc_fused.run_fused`); state on the CPU through
the plain :func:`..models.shan_chen.run`.
"""
from __future__ import annotations

import torch

from ..io.config import lb_parameters, load_config, omega_from_tau
from ..models import shan_chen as sc
from ..ops import sc_fused
from .common import Driver, next_chunk


def _num(cfg, key, default):
    return float(cfg.get(key, default))


def _int(cfg, key, default):
    return int(float(cfg.get(key, default)))


def _omega(cfg, N):
    """tau override wins over (Re, ulb) (reference laplace2D.h:441-449)."""
    tau = float(cfg.get("tau", -1.0))
    if tau > 0:
        nu, omega = omega_from_tau(tau)
        dx = 1.0 / N
        dt = dx * _num(cfg, "ulb", 0.1)
    else:
        nu, omega, dx, dt = lb_parameters(_num(cfg, "ulb", 0.1), N,
                                          _num(cfg, "Re", 60.0))
    return omega, dx, dt


# ─── Shan-Chen Laplace droplet (reference laplace2D.h driver :405-512) ─────
def run_sc_laplace2d(config, outdir, dtype=torch.float64, max_steps=None, *,
                     device):
    cfg = load_config(config)
    N = _int(cfg, "N", 100)
    omega, dx, dt = _omega(cfg, N)
    p = sc.SCParams(
        omega=omega, a=_num(cfg, "a", 1.0), b=_num(cfg, "b", 4.0),
        R=_num(cfg, "R", 1.0), TT0=_num(cfg, "TT0", 0.875),
        rhol=_num(cfg, "rhol", 1.0), rhog=_num(cfg, "rhog", 0.1),
        rho_w=_num(cfg, "rho_w", 0.12), gravity=_num(cfg, "gravity", 0.0))
    # reference laplace2D.h:137 hardcodes Rdrop=10; honor an RR config key
    # when present (the contactAngle2D family reads it) with that default
    f = sc.init_droplet(N, N, p, radius=_num(cfg, "RR", 10.0), dtype=dtype,
                        device=device)
    fluid = sc.geometry_periodic(N, N, device=device)
    steps = max_steps or int(_num(cfg, "max_t", 10.0) / dt)
    return _run_sc(p, f, fluid, steps, cfg, outdir, dx, dt, contact=False,
                   periodic=True)


# ─── Shan-Chen contact angle (reference contactAngle2D.h :644-807) ─────────
def run_sc_contact_angle(config, outdir, dtype=torch.float64, max_steps=None,
                         *, device):
    cfg = load_config(config)
    N = _int(cfg, "N", 200)
    omega, dx, dt = _omega(cfg, N)
    p = sc.SCParams(
        omega=omega, a=_num(cfg, "a", 1.0), b=_num(cfg, "b", 4.0),
        R=_num(cfg, "R", 1.0), TT0=_num(cfg, "TT0", 0.875),
        rhol=_num(cfg, "rhol", 0.265), rhog=_num(cfg, "rhog", 0.038),
        rho_w=_num(cfg, "rhow", _num(cfg, "rho_w", 0.2)),
        gravity=_num(cfg, "gravity", 0.0))
    nx, ny = 2 * N, N
    RR = _num(cfg, "RR", 100.0)
    f = sc.init_droplet(nx, ny, p, radius=RR, center=(nx // 2, 5.0),
                        dtype=dtype, device=device)
    fluid = sc.geometry_channel_walls(nx, ny, device=device)
    f = sc.apply_geometry(f, fluid)
    steps = max_steps or int(_num(cfg, "max_t", 50.0) / dt)
    return _run_sc(p, f, fluid, steps, cfg, outdir, dx, dt, contact=True,
                   periodic=False)


def _run_sc(p, f, fluid, steps, cfg, outdir, dx, dt, contact, periodic):
    ny, nx = fluid.shape
    drv = Driver(outdir, nx * ny, out_freq=_int(cfg, "out_freq", 400),
                 vtk_freq=_int(cfg, "vtk_freq", 400))
    fluid_f32 = fluid.to(torch.float32)
    flm = fluid.to(f.dtype)
    it = 0
    while it < steps:
        if drv.want_vtk(it):
            # fields stay on the device: the dump stages their host copies
            # without blocking the time loop
            rho = sc.density(f)
            pr = sc.node_pressure(f, p)
            F = sc.sc_force(rho, fluid, p)
            drv.write_vtk(it, nx, ny, spacing=dx,
                          scalars=[("Density", rho * flm),
                                   ("Pressure", pr * flm)],
                          vectors=[("Force", F)])
        if drv.want_out(it):
            e = float(sc.kinetic_energy(f, fluid, p)) * dx * dx / (dt * dt)
            m = float(sc.total_mass(f, fluid))
            drv.log_file("energy.dat").log(it * dt, e)
            drv.log_file("mass.dat").log(it * dt, m)
            if contact:
                res = sc.contact_angle(sc.density(f).cpu().numpy(),
                                       fluid.cpu().numpy(), p.rhol, p.rhog)
                if res:
                    drv.log_file("contact_angle.dat").log(*res)
        chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
        f = sc_fused.run_fused(f, fluid_f32, p, chunk, periodic=periodic)
        drv.clock.tick(chunk)
        it += chunk
    if f.is_cuda:
        torch.cuda.synchronize(f.device)   # the MLUPS line times finished work
    drv.finish()
    return f
