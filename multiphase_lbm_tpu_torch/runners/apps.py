"""Per-problem drivers, schema-compatible with the reference app modules.

Port of the Shan–Chen, HCZ, Fakhari, SC Rayleigh–Taylor, pulsatile and
combustion runners of ``multiphase_lbm_tpu/runners/apps.py``
(``run_sc_laplace2d``, ``run_sc_contact_angle``, ``run_sc_two_layered``,
``run_young_laplace2d``,
``run_rayleigh_taylor_pf``, ``run_two_layered_pf``, ``run_laplace3d``,
``run_rayleigh_taylor_sc``, ``run_pulsatile``, ``run_combustion``).
Each reads the reference's
``config_*.txt`` keys (the pulsatile and combustion drivers take none), runs
the solver in chunks of the output cadence and emits the same observables:
``sol_*.vtk`` with the module's field list, ``energy.dat`` / ``mass.dat`` /
``contact_angle.dat`` / ``spike_bubble_position.dat`` /
``spike_bubble_velocity.dat`` / ``density_probe.dat``, the combustion
audits, and the final MLUPS line.  State on a CUDA device
advances through the fused kernels (:mod:`..ops.sc_fused`,
:mod:`..ops.hcz_fused`, :mod:`..ops.hcz3d_fused`, :mod:`..ops.fakhari_fused`,
:mod:`..ops.scrt_fused`, :mod:`..ops.pulsatile_fused`,
:mod:`..ops.combustion_fused`); state on the CPU through the plain model
functions.  The runners keep the lattice and the dtype of the JAX XLA path
(no 8-row padding, no forced float32), so VTK dimensions and the MLUPS
element count match the JAX CLI without ``--fused``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io import checkpoint as ckpt
from ..io.config import lb_parameters, load_config, omega_from_tau
from ..models import combustion as cb
from ..models import fakhari as fk
from ..models import hcz
from ..models import shan_chen as sc
from ..models import pulsatile as pb
from ..models import shan_chen_rt as rt
from ..ops import (combustion_fused, fakhari_fused, hcz3d_fused, hcz_fused,
                   pulsatile_fused, sc_fused, scrt_fused)
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


# ─── Shan-Chen layered flow (reference SC twoLayeredFlow2D.h :457-598) ─────
def run_sc_two_layered(config, outdir, dtype=torch.float64, max_steps=None,
                       *, device):
    cfg = load_config(config)
    N = _int(cfg, "N", 100)
    omega, dx, dt = _omega(cfg, N)
    p0 = sc.SCParams(
        omega=omega, a=_num(cfg, "a", 1.0), b=_num(cfg, "b", 4.0),
        R=_num(cfg, "R", 1.0), TT0=_num(cfg, "TT0", 0.95),
        rhol=_num(cfg, "rhol", 0.21), rhog=_num(cfg, "rhog", 0.067),
        rho_w=_num(cfg, "rho_w", 0.067), psi_mode="const_g",
        G=_num(cfg, "G", -1.0), gx_u=_num(cfg, "gx", 1e-8),
        gy_u=_num(cfg, "gy", 0.0))
    p = dataclasses.replace(p0, p_shift=sc.compute_p_shift(p0))
    f = sc.init_layers(N, N, p, h_lower=_num(cfg, "h_lower", 0.3),
                       w_int=_int(cfg, "w_int", 4), dtype=dtype, device=device)
    fluid = sc.geometry_channel_walls(N, N, device=device)
    f = sc.apply_geometry(f, fluid)
    steps = max_steps or int(_num(cfg, "max_t", 200.0) / dt)
    return _run_sc(p, f, fluid, steps, cfg, outdir, dx, dt, contact=False,
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
            with drv.dump(it):
                # fields stay on the device: the dump stages their host
                # copies without blocking the time loop
                rho = sc.density(f)
                pr = sc.node_pressure(f, p)
                F = sc.sc_force(rho, fluid, p)
                drv.write_vtk(it, nx, ny, spacing=dx,
                              scalars=[("Density", rho * flm),
                                       ("Pressure", pr * flm)],
                              vectors=[("Force", F)])
        if drv.want_out(it):
            with drv.record(it):
                e = drv.scalar(sc.kinetic_energy(f, fluid, p)) * dx * dx / (dt * dt)
                m = drv.scalar(sc.total_mass(f, fluid))
                drv.log_file("energy.dat").log(it * dt, e)
                drv.log_file("mass.dat").log(it * dt, m)
                if contact:
                    res = sc.contact_angle(drv.numpy(sc.density(f)),
                                           drv.numpy(fluid), p.rhol, p.rhog)
                    if res:
                        drv.log_file("contact_angle.dat").log(*res)
        with drv.chunk(it):
            chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
            f = sc_fused.run_fused(f, fluid_f32, p, chunk, periodic=periodic)
            drv.clock.tick(chunk)
        it += chunk
    _finish(drv, f)
    return f


# ─── Fakhari Young-Laplace (reference Young_Laplace2D.h :456-568) ──────────
def run_young_laplace2d(config, outdir, dtype=torch.float64, max_steps=None,
                        *, device):
    cfg = load_config(config)
    N = _int(cfg, "N", 128)
    p = fk.FakhariParams(
        sigma=_num(cfg, "Sigma", 0.01), W=_num(cfg, "W", 4.0),
        M=_num(cfg, "M", 0.02), rhol=_num(cfg, "RhoL", 0.001),
        rhoh=_num(cfg, "RhoH", 1.0), tau=_num(cfg, "tau", 0.8))
    state = fk.init_bubble(N, N, p, dtype=dtype, device=device)
    steps = max_steps or _int(cfg, "tf", 10000)
    drv = Driver(outdir, N * N, out_freq=_int(cfg, "out_freq", 1000),
                 vtk_freq=_int(cfg, "vtk_freq", 1000))
    flag = np.zeros((N, N), int)
    it = 0
    # the reference's loop runs to it == steps inclusive, one step past it
    while it <= steps:
        if drv.want_vtk(it):
            with drv.dump(it):
                drv.write_vtk(it, N, N,
                              scalars=[("phi", fk.phase_field(state)),
                                       ("Pressure", fk.pressure(state))],
                              vectors=[("velocity", state[2])],
                              int_scalars=[("Flag", flag)])
        if drv.want_out(it):
            with drv.record(it):
                drv.log_file("energy.dat").log(
                    it, drv.scalar(fk.kinetic_energy(state)))
                drv.log_file("mass.dat").log(
                    it, drv.scalar(fk.total_mass(state, p)))
        with drv.chunk(it):
            chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
            state = fakhari_fused.run_fused(*state, p, chunk)
            drv.clock.tick(chunk)
        it += chunk
    _finish(drv, state[0])
    return state


def _hcz_params(cfg, omega, kappa, **extra):
    return hcz.HCZParams(
        omega=omega, phi_l=_num(cfg, "phi_l", 0.251),
        phi_g=_num(cfg, "phi_g", 0.024), rho_l=_num(cfg, "rho_l", 0.12),
        rho_g=_num(cfg, "rho_g", 0.04), a=_num(cfg, "a", 4.0),
        b=_num(cfg, "b", 4.0), kappa=_num(cfg, "kappa", kappa), **extra)


def _flag(drv, fluid):
    """The VTK ``Flag`` field: 1 at solid cells (static, tiny)."""
    return (~drv.numpy(fluid)).astype(int)


# ─── HCZ Rayleigh-Taylor (reference PF rayleighTaylor2D.h :862-988) ────────
def run_rayleigh_taylor_pf(config, outdir, dtype=torch.float64, max_steps=None,
                           *, device):
    cfg = load_config(config)
    N = _int(cfg, "N", 256)
    nu, omega, dx, dt = lb_parameters(_num(cfg, "ulb", 0.04), N,
                                      _num(cfg, "Re", 3000.0))
    p = _hcz_params(cfg, omega, 0.01, gravity=_num(cfg, "gravity", -6.25e-6))
    ny = 4 * N + 2
    fluid = hcz.geometry_channel(N, ny, device=device)
    state = hcz.apply_geometry(
        hcz.init_rayleigh_taylor(N, ny, p, dtype=dtype, device=device), fluid)
    steps = max_steps or int(_num(cfg, "max_t", 5.01) / dt)
    drv = Driver(outdir, N * ny, out_freq=_int(cfg, "out_freq", 3200),
                 vtk_freq=_int(cfg, "vtk_freq", 3200))
    fluid_f32 = fluid.to(torch.float32)
    flag = _flag(drv, fluid)
    it = 0
    prev_sb = None
    while it < steps:
        if drv.want_vtk(it):
            with drv.dump(it):
                phi = hcz.order_parameter(state[0])
                drv.write_vtk(it, N, ny, spacing=1.0 / N,
                              scalars=[("phi", phi),
                                       ("density", hcz.rho_of_phi(phi, p))],
                              int_scalars=[("Flag", flag)])
        if drv.want_out(it):
            with drv.record(it):
                e = drv.scalar(hcz.kinetic_energy(state, fluid, p)) * dx * dx / (dt * dt)
                drv.log_file("energy.dat").log(it * dt, e)
                s, b = hcz.interface_heights(
                    drv.numpy(hcz.order_parameter(state[0])), p)
                drv.log_file("spike_bubble_position.dat").log(
                    it * dt, s * dx, b * dx)
                # finite-difference interface velocities over the output
                # cadence (the series the reference's validation notebook
                # derives from the positions)
                if prev_sb is not None:
                    t_prev, s_prev, b_prev = prev_sb
                    dti = it * dt - t_prev
                    drv.log_file("spike_bubble_velocity.dat").log(
                        it * dt, (s * dx - s_prev) / dti, (b * dx - b_prev) / dti)
                prev_sb = (it * dt, s * dx, b * dx)
        with drv.chunk(it):
            chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
            state = hcz_fused.run_fused(*state, fluid_f32, p, chunk)
            drv.clock.tick(chunk)
        it += chunk
    _finish(drv, state[0])
    return state


# ─── HCZ layered channel (reference PF twoLayeredFlow2D.h :762-905) ────────
def run_two_layered_pf(config, outdir, dtype=torch.float64, max_steps=None,
                       *, device):
    cfg = load_config(config)
    N = _int(cfg, "N", 100)
    omega, dx, dt = _omega(cfg, N)
    p = _hcz_params(cfg, omega, 0.001, gx=_num(cfg, "gx", 0.0),
                    Gx_const=_num(cfg, "Gx_const", 1e-8))
    fluid = hcz.geometry_channel(N, N, device=device)
    state = hcz.apply_geometry(
        hcz.init_layers(N, N, p, h_lower=_num(cfg, "h_lower", 0.3),
                        w_int=_int(cfg, "w_int", 2), dtype=dtype,
                        device=device), fluid)
    steps = max_steps or int(_num(cfg, "max_t", 50.0) / dt)
    drv = Driver(outdir, N * N, out_freq=_int(cfg, "out_freq", 500),
                 vtk_freq=_int(cfg, "vtk_freq", 1000))
    fluid_f32 = fluid.to(torch.float32)
    flag = _flag(drv, fluid)
    it = 0
    while it < steps:
        if drv.want_vtk(it):
            with drv.dump(it):
                phi = hcz.order_parameter(state[0])
                drv.write_vtk(it, N, N, spacing=dx,
                              scalars=[("phi", phi),
                                       ("density", hcz.rho_of_phi(phi, p))],
                              int_scalars=[("Flag", flag)])
        if drv.want_out(it):
            with drv.record(it):
                e = drv.scalar(hcz.kinetic_energy(state, fluid, p)) * dx * dx / (dt * dt)
                drv.log_file("energy.dat").log(it * dt, e)
                rho = hcz.rho_of_phi(hcz.order_parameter(state[0]), p)
                drv.log_file("density_probe.dat").log(
                    it * dt, drv.scalar(rho[N // 2, N // 2]),
                    drv.scalar(rho[2, N // 2]))
        with drv.chunk(it):
            chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
            state = hcz_fused.run_fused(*state, fluid_f32, p, chunk)
            drv.clock.tick(chunk)
        it += chunk
    _finish(drv, state[0])
    return state


# ─── HCZ 3D droplet (reference laplace3D.h :853-952) ───────────────────────
def run_laplace3d(config, outdir, dtype=torch.float64, max_steps=None, *,
                  device):
    cfg = load_config(config)
    N = _int(cfg, "N", 100)
    nu, omega, dx, dt = lb_parameters(_num(cfg, "ulb", 0.01), N,
                                      _num(cfg, "Re", 6.0))
    p = _hcz_params(cfg, omega, 5e-4, gravity=_num(cfg, "gravity", 0.0))
    state = hcz.init_droplet_3d(N, N, N, p, dtype=dtype, device=device)
    fluid = hcz.geometry_periodic_3d(N, N, N, device=device)
    steps = max_steps or int(_num(cfg, "max_t", 5.0) / dt)
    drv = Driver(outdir, N ** 3, out_freq=_int(cfg, "out_freq", 100),
                 vtk_freq=_int(cfg, "vtk_freq", 100))
    it = 0
    while it < steps:
        if drv.want_vtk(it):
            with drv.dump(it):
                drv.write_vtk(it, N, N, N, spacing=1.0 / N,
                              scalars=[("phi", hcz.order_parameter(state[0]))])
        if drv.want_out(it):
            with drv.record(it):
                e = drv.scalar(hcz.kinetic_energy(state, fluid, p, hcz.D3Q19,
                                                  three_d=True))
                drv.log_file("energy.dat").log(it * dt, e)
        with drv.chunk(it):
            chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
            state = hcz3d_fused.run_fused_3d(*state, p, chunk)
            drv.clock.tick(chunk)
        it += chunk
    _finish(drv, state[0])
    return state


# ─── SC Rayleigh-Taylor (reference SC RayleighTaylor2D.h :578-670) ─────────
def run_rayleigh_taylor_sc(config, outdir, dtype=torch.float64, max_steps=None,
                           *, device):
    cfg = load_config(config)
    N = _int(cfg, "N", 128)
    nu, omega, dx, dt = lb_parameters(_num(cfg, "ulb", 0.04), N,
                                      _num(cfg, "Re", 30.72))
    p = rt.SCRTParams(
        omega=omega, rhol=_num(cfg, "rhol", 1.2), rhog=_num(cfg, "rhog", 0.4),
        g=_num(cfg, "g", -5.0), gravity=_num(cfg, "gravity", -1.25e-5))
    nx, ny = N, 4 * N + 2     # reference dim {N, 4N+2} (RayleighTaylor2D.h:622)
    fluid = rt.geometry_channel(nx, ny, device=device)
    f = rt.init_interface(nx, ny, p, dtype=dtype, device=device) * fluid[None]
    steps = max_steps or int(_num(cfg, "max_t", 50.01) / dt)
    drv = Driver(outdir, nx * ny, out_freq=_int(cfg, "out_freq", 100),
                 vtk_freq=_int(cfg, "vtk_freq", 100))
    flag = _flag(drv, fluid)
    fluid_host = drv.numpy(fluid)
    it = 0
    while it < steps:
        if drv.want_vtk(it):
            with drv.dump(it):
                drv.write_vtk(it, nx, ny, spacing=dx,
                              scalars=[("Density", rt.density(f))],
                              int_scalars=[("Flag", flag)])
        if drv.want_out(it):
            with drv.record(it):
                e = drv.scalar(rt.kinetic_energy(f, fluid, p)) * dx * dx / (dt * dt)
                drv.log_file("energy.dat").log(it * dt, e)
                rho = rt.density(f)
                drv.log_file("mass.dat").log(
                    it * dt, drv.scalar((rho * fluid).sum()))
                s, bub = rt.interface_height(drv.numpy(rho), fluid_host, p)
                drv.log_file("spike_bubble_position.dat").log(
                    it * dt, s * dx, bub * dx)
        with drv.chunk(it):
            chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
            f = scrt_fused.run_fused(f, p, chunk)
            drv.clock.tick(chunk)
        it += chunk
    _finish(drv, f)
    return f


# ─── Pulsatile vessel (reference PulsatileBloodFlow2D.h :719-794) ──────────
def run_pulsatile(outdir, N=64, dtype=torch.float64, max_steps=None,
                  momentum_quirk=True, *, device):
    """The severed compliant vessel at nx = 1 + 10 (N − 2), ny = N.  The
    parity mode advances through the kernel on a CUDA device; the
    quirk-free physics mode has no kernel (in the JAX package either) and
    runs the plain path, which it says on stdout when on the card."""
    p = pb.PulsatileParams(nx=1 + 10 * (N - 2), ny=N,
                           momentum_quirk=momentum_quirk)
    state = pb.initialize(p, dtype, device=device)
    tf = max_steps or (p.beat + 2 * p.t_propagation)
    step_freq = max(1, tf // 100)
    drv = Driver(outdir, p.nx * p.ny, out_freq=step_freq, vtk_freq=step_freq)
    if not momentum_quirk and state.P.is_cuda:
        print("PulsatileBloodFlow2D --quirk-free: no kernel implements the "
              "physics mode; running the plain PyTorch path on the card")
    # dump instants: the post-step times that are multiples of step_freq
    # (the reference's tf/100 cadence), plus the final step; each chunk's
    # last step is the next dump instant
    dumps = sorted(set(range(0, tf + 1, step_freq)) | {tf})
    it = 0                                   # next step index to run
    for dump_t in dumps:
        with drv.chunk(it):
            chunk = dump_t - it + 1
            if momentum_quirk:
                state, _ = pulsatile_fused.run_fused_full(state, it, p, chunk)
            else:
                state = pb.run(state, it, p, chunk)
            drv.clock.tick(chunk)
        it = dump_t + 1
        with drv.dump(dump_t):
            drv.write_vtk(dump_t, p.nx, p.ny, spacing=1.0 / p.nx,
                          scalars=[("P", state.P), ("Ux", state.Ux),
                                   ("Uy", state.Uy)],
                          int_scalars=[("Flag", (~state.fluid).to(torch.int32))])
    _finish(drv, state.g_stream)
    return state


# ─── Combustion channel (reference runCavityTwoPop :4074-4496) ─────────────
# physical time-step size and the Middleline dump times of the reference
# (CooLBM_MRT_combustion.cpp:79, :4431-4441)
CB_DELTA_T_PH = 1.0 / 48771706.22
CB_MIDDLELINE_TIMES = (0.002, 0.006)


def _combustion_vtk(drv, st, p, flags, it):
    """VTK dump with the reference's field list, velocity_Z included
    (saveVtkFields, CooLBM_MRT_combustion.cpp:3560-3711; 2D run, so 0)."""
    rho, u = cb.macro_flow(st.f)
    drv.write_vtk(it, p.nx, p.ny,
                  scalars=[("Density", rho),
                           ("Temperature", cb.macro_scalar(st.gT)),
                           ("mass_fraction_O2", cb.macro_scalar(st.gO2)),
                           ("mass_fraction_CO2", cb.macro_scalar(st.gCO2)),
                           ("velocity_X", u[0]),
                           ("velocity_Y", u[1]),
                           ("velocity_Z", np.zeros((p.ny, p.nx)))],
                  int_scalars=[("Flag", flags.astype(int))])


def _combustion_runner(p):
    """:func:`..ops.combustion_fused.run_fused` where the kernel covers
    ``p`` (on the CPU it runs the plain path); otherwise the plain path,
    with a line that says so and why (the GUO2015 and HUBER2015 schemes:
    neither has a kernel, in the JAX package either)."""
    refused = combustion_fused.unsupported(p)
    if refused:
        print("combustion: the kernel does not cover " + ", ".join(refused)
              + "; running the plain PyTorch path")
        return cb.run
    return combustion_fused.run_fused


def run_combustion(outdir, nx=420, ny=80, dtype=torch.float64,
                   flow_steps=20000, scalar_steps=5000, T_solid=None,
                   conj_scheme="li2014", restart=None, save_flow=True,
                   benchmark=False, bench_ini_iter=1000, bench_max_iter=2000,
                   topology="inflow_outflow", u_lid=None, dpdx=0.0, *,
                   device):
    """Two-stage combustion driver (reference main :4074-4496).

    ``restart`` warm-starts the flow from a reference-format ``ini_f.dat``
    and skips the flow-convergence stage, as the reference's two-stage
    workflow does; ``save_flow`` writes the converged field back out.
    ``benchmark`` is the reference's bench mode (:4376-4380): flow only,
    ``bench_ini_iter`` warm-up steps, then the MLUPS of the remaining
    ``bench_max_iter − bench_ini_iter``.  ``topology`` selects the
    reference's domain branches (:154-254, :3756-4073): cavity (moving lid
    ``u_lid``), couette (moving top wall, periodic x), poiseuille (body force
    ``dpdx``, periodic x), or the default reactive inflow/outflow channel,
    the only one with the Xu-2018 obstacles."""
    # a lid speed exists only for the moving-wall topologies
    if u_lid is None:
        u_lid = 0.002 if topology in ("cavity", "couette") else 0.0
    p = cb.CombustionParams(nx=nx, ny=ny, conj_scheme=conj_scheme,
                            topology=topology, u_lid=u_lid, dpdx=dpdx,
                            with_obstacles=(topology == "inflow_outflow"))
    flags, _ = cb.build_geometry(p)
    tab = cb.build_static_tables(flags, p)
    runner = _combustion_runner(p)

    def sync(st):
        if st.f.is_cuda:
            torch.cuda.synchronize(st.f.device)

    if benchmark:
        import time
        st = cb.initialize(p, dtype, T_solid=T_solid, flags=flags,
                           device=device)
        st = runner(st, p, bench_ini_iter, konv=False)
        sync(st)
        n = bench_max_iter - bench_ini_iter
        t0 = time.perf_counter()
        st = runner(st, p, n, konv=False)
        sync(st)
        dt_s = time.perf_counter() - t0
        print(f"MLUPS: {nx * ny * n / dt_s / 1e6:.1f}")
        return st

    f0 = None
    if restart is not None:
        f0 = ckpt.load_flow_field_txt(restart)
        if f0.shape != (9, ny, nx):
            raise ValueError(
                f"restart field {f0.shape[1:]} does not match the requested "
                f"lattice ({ny}, {nx}); pass matching --ny/--nx")
    st = cb.initialize(p, dtype, T_solid=T_solid, flags=flags, f_restart=f0,
                       device=device)
    drv = Driver(outdir, nx * ny, out_freq=1000, vtk_freq=0)

    def log(done, e, dev):
        with drv.record(done):
            drv.log_file("energy.dat").log(done, e, dev)

    if restart is not None:
        # a restarted run trusts the converged field and goes straight to
        # the reactive stage (:4345, :536-542)
        done = 0
    else:
        st, done = cb.run_staged(st, p, max_flow_steps=flow_steps,
                                 check_every=500, scalar_steps=0, log=log,
                                 runner=runner)
        if save_flow:
            ckpt.save_flow_field_txt(f"{outdir}/ini_f.dat", st.f)

    # reactive stage, chunked so that the Middleline dumps fire when the
    # run crosses the reference's fixed physical times (:4431-4441)
    it = done
    if scalar_steps > 0:
        st = runner(st, p, 1, konv=True, first_step=True)
        it += 1
        left = scalar_steps - 1
        while left > 0:
            with drv.chunk(it):
                chunk = min(left, 500)
                t_prev = it * CB_DELTA_T_PH
                st = runner(st, p, chunk, konv=True)
            it += chunk
            left -= chunk
            t_now = it * CB_DELTA_T_PH
            for t_mark in CB_MIDDLELINE_TIMES:
                if t_prev < t_mark <= t_now:
                    with drv.record(it):
                        cb.middleline(outdir, st, tab, p, t_ph=t_mark)
    it_total = it
    cb.middleline(outdir, st, tab, p, t_ph=it_total * CB_DELTA_T_PH)

    drv.clock.tick(it_total)
    drv.log_file("thermal-energy.dat").log(
        it_total, drv.scalar(cb.thermal_energy(st, tab, p)))
    cb.save_profiles(outdir, st, tab, p)
    cb.conservation_audit(outdir, st, tab, p)
    _combustion_vtk(drv, st, p, flags, it_total)
    fin, fout = cb.mass_flux_audit(st, tab, p)
    drv.log_file("conservation.dat").log(drv.scalar(fin), drv.scalar(fout))
    _finish(drv, st.f)
    return st


def _finish(drv, f):
    if f.is_cuda:
        torch.cuda.synchronize(f.device)   # the MLUPS line times finished work
    drv.finish()
