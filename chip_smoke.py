#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA
kernels, holds each against the plain PyTorch path, drives the main path of
each model family and checks the physics.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device   — a CUDA device is required; prints the card's name and power
                limit as nvidia-smi reports them.
  2. build    — nvcc builds csrc/*.cu, one process per source, all started
                together; prints the seconds and the ptxas report (registers
                and spills of every kernel), and the registers and spills of
                sc_step_kernel's four instantiations in float32 and float64.
  3. kernel vs plain on the card:
     sc_step — ω = 1.25 (τ = 0.8) so the rank-2 MRT term is live:
       {periodic 256², walled 256×128 with ρ_w = 0.2 and the droplet on the
       wall} × {BGK, MRT}, float32 over 5 steps (rtol 2e-5, atol 2e-6: sum
       order and FMA contraction differ from the plain path) and float64
       over 20 steps (atol 1e-12); the constant-G layered channel 64² with a
       per-node force (gx_u = 1e-6, gy_u = −3e-7), BGK and MRT, and MRT on
       lattices that are not multiples of the kernel's 32×8 tile or are
       narrower than its ring (channels 45×37 and 3×5, periodic 7×2, and
       45×37 with an obstacle across the tile edges), all at ω = 1.25 at the
       same tolerances; and 2048² periodic MRT float32, 5 steps.
     hcz_step — RTI channel 256×1026 with gravity at ω = 1.25 and at the
       config's ω = 1.96, layered channel 128×128 with Gx_const at
       ω = 1.25, and lattices that are not multiples of the kernel's 32×8
       tile or are narrower than its 2-cell halo (channels 45×37 and 3×5,
       periodic 7×2, nx×ny, and 45×37 with an obstacle across the tile
       edges, at ω = 1.25): float32 over 5 steps (rtol 3e-5, atol 3e-6)
       and float64 over 20 steps (atol 1e-12); and RTI-2048 (2048×8194)
       float32, 5 steps.
     hcz3d_step — 64³ droplet at ω = 1.2, and droplets in boxes that are
       not multiples of the kernel's 32×8 tile or 16-plane chunk (37×11×9)
       or thinner in z than its 7-plane φ window (33×9×3), float32 over 5
       steps (rtol 5e-5, atol 5e-6) and float64 over 20 steps (atol
       1e-12); and 128³ float32, 3 steps.
  4. SC main path — multiphase_lbm_tpu_torch.bench at 2048², MRT, float32,
     periodic, through the kernel (slope protocol; and bench --profile 20
     in a process of its own: device ms a step and idle share), beside the
     plain path at the same size; state finite, mass drift < 1e-4 (summed in
     float64), droplet ρ ≈ 0.265 inside and ≈ 0.038 far away (±10%).
  5. SC CLI   — coolbm laplace2D_sc --f32 --steps 800 with the repo config
     writes sol_0000000.vtk, sol_0000400.vtk, mass.dat, energy.dat and its
     MLUPS line, through the kernel.
  5b. SC layered channel — validation.layered_poiseuille through sc_step
     (64², 40,000 float64 steps, constant-G ψ, per-node force): deviation
     from the analytic profile < 0.25, its wall time printed; coolbm
     twoLayeredFlow2D_sc --steps 400 (config N = 100, float64) writes
     sol_0000000.vtk, energy.dat, mass.dat and its MLUPS line through
     sc_step; the 64² float64 step timed through the kernel (slope
     2000/6000) and the plain path (5/15).
  6. RTI main path — bench --model rti: RTI-2048 float32 through hcz_step
     (slope 50/150 steps) beside the plain path (2/6 steps); state finite,
     phase-mass drift Σf < 1e-4 (summed in float64).
  7. literature gate — validation.rti_regression to t = 2 at N = 256
     (12,800 steps through hcz_step): position deviations from the
     published curves < 0.15, velocity deviations < 0.25.
  8. RTI CLI  — coolbm rayleighTaylor2D --f32 --steps 6400 (config N = 256)
     writes sol_0000000.vtk, sol_0003200.vtk, energy.dat,
     spike_bubble_position.dat, spike_bubble_velocity.dat and its MLUPS
     line, through hcz_step.
  9. 3D main path — bench --model hcz3d: 128³ float32 through hcz3d_step
     (slope 50/150) beside the plain path (2/6), and bench --model hcz3d
     --profile 20 in a process of its own: LAUNCHES_PER_STEP (2) B5
     launches a step, and their device time; then coolbm laplace3D
     --f32 --steps 200 (config N = 100) writes its files through
     hcz3d_step.
 10. Fakhari main path — bench --model fakhari: the 2048² bubble float32
     through fakhari_step (slope 100/300) beside the plain path (2/6);
     state finite, Σφ drift < 1e-4 (summed in float64); the Laplace gate
     of tests/test_fakhari.py through the kernel (64² float64, 2000 steps:
     ΔP within 35% of σ/R, Σφ conserved to 1e-12); coolbm Young_Laplace2D
     --f32 --steps 2000 (config N = 128) writes sol_0000000.vtk,
     sol_0001000.vtk, energy.dat, mass.dat and its MLUPS line.
 11. SC-RT main path — bench --model scrt: 2048 × 8194 float32 through
     scrt_step (slope 100/300) beside the plain path (2/6); state finite,
     mass drift < 1e-4 (summed in float64); the C++ capture
     (config N = 128, float64) at steps 250 and 1000 within 5e-5 on both
     probe columns, steps 2000 and 3000 printed; coolbm RayleighTaylor2D_sc
     --f32 --steps 200 (config N = 128) writes sol_0000000.vtk,
     sol_0000100.vtk, energy.dat, mass.dat, spike_bubble_position.dat and
     its MLUPS line.
 12. pulsatile main path — bench --model pulsatile at N = 384 (3,821 × 384,
     wall compliance scaled to the size, 4N warm-up steps through
     pulsatile_step, slope 100/300; N >= 512 goes non-finite in the opening
     transient) and at the reference's N = 64 (621 × 64, slope 500/1500),
     each beside its plain path (2/6), with each launch's device time from
     one more profiled call of 50 (N = 384) or 200 steps; state finite,
     fluid share > 0.5 at N = 384, LAUNCHES_PER_STEP (5) pulsatile_step
     launches a step in each profile; the registers and spills of the B6
     kernels (ptxas, phase 2's build).  After these timed runs, three worker processes run the plain
     paths behind the gates while this process runs coolbm
     PulsatileBloodFlow2D --f32 --steps 300 (its 101 dumps, sol_0000000.vtk,
     sol_0000150.vtk, sol_0000300.vtk, ..., and its MLUPS line through
     pulsatile_step) and the kernel's runs of the full-run gate
     (validation.pulsatile_fullrun: the 2765-step reference case through
     pulsatile_step at float32, and eight runs of it perturbed by an ulp,
     against the plain path's float64 run: the medians of the GATED_F32
     metrics within GATES_F32, every run's phase lag within ±1 dump;
     order-dependent reseed steps <= 12, reseeded cells > 0; then the
     self-check: eight float64 runs perturbed by an ulp keep the gated
     metrics within half their gates against the unperturbed one); the
     workers' quirk-free physics gates through the plain path
     (validation.womersley: module channel steady < 0.04, shape < 0.15,
     budget < 0.20; core channel steady < 0.003, oscillatory < 0.02).
 13. combustion (runs before phase 12, whose worker processes share the
     card: timed work stays out of that window) — combustion_step against
     the plain path from a warm state (Y_O2_ini = 0.22, T_solid = 1.8, ten
     kernel steps, so the reaction is live): (a) the inflow/outflow channel
     137 × 45, li2014, the default τ (flow relaxation diagonal all ones);
     (b) τ_flow = 0.8, w_e = 1.1, w_eps = 1.2, w_q = 1.3 (full flow MRT);
     (c) (b) with first_step; (d) (b) flow only; (e) scheme none without
     the solid reaction; (f) the cavity with all four populations, Couette
     and Poiseuille (body force, τ_flow = 0.8) flow only; the boundary
     launch's reordered dependencies: the channel at 8 × 5 (the bottom
     row's amplitude reads the fixed top row), 12 × 6 and 5 × 5; the
     collision factors: (b) with τ_O2 ≠ τ_CO2 and τ_T ≠ τ_T_solid, every
     factor distinct, and the flow's four rates equal at 1.25 (BGK at
     ω ≠ 1 up to the conserved moments) in the channel and in Poiseuille
     flow only: float32 over 5
     steps (rtol 2e-5, atol 2e-6, tighter than the Pallas test's 2e-4 and
     5e-6) and float64 over 20 steps (atol 1e-12),
     f, g_O2, g_CO2 over bulk and obstacle cells, g_T and g_coll over every
     cell, the forcing terms over bulk cells; and 420 × 80 and 840 × 160
     float32, 5 steps, from the bench's warm state, and 420 × 80 flow only
     (its own code path).  The registers and spills of the three B7
     kernels (ptxas, phase 2's build).  The C++ capture
     (128 × 48, float64, every step in the binary's first_step mode): every
     field of validation.combustion_reference.FIELDS within its tolerance
     at steps 100-500 through combustion_step; the float32 run printed.
     Main path: bench --model combustion at 420 × 80 and 840 × 160 (all four
     populations) and 420 × 80 flow only, slope 200/600 after a 2N-step
     warm-up, each beside its plain path (2/6), with each launch's device
     time from one more profiled call of 20 steps; bulk state finite, inflow
     and outflow mass flux (mass_flux_audit) positive, thermal energy
     finite; coolbm combustion --f32 --steps 1000 --scalar-steps 500 writes
     ini_f.dat, sol_*.vtk with velocity_Z, a velocity_middleline_*.dat,
     the audit files, energy.dat, thermal-energy.dat, conservation.dat and
     its MLUPS line; then --restart <its ini_f.dat> --scalar-steps 200,
     --topology cavity --u-lid 0.01 and the reference's --bench protocol
     (flow only, 1000 warm-up and 1000 timed steps), all through
     combustion_step.
In phase 3 also: fakhari_step on the 128² bubble at τ = 0.8 and 0.55,
float32 over 5 steps (rtol 5e-5, atol 5e-6) and float64 over 20 steps
(atol 1e-12), and 2048² float32, 5 steps; scrt_step on the 128 × 514
channel at ω = 1 and 1.25, float32 over 5 steps (rtol 2e-5, atol 2e-6) and
float64 over 20 steps (atol 1e-12), and 2048 × 8194 float32, 5 steps;
pulsatile_step at N = 64 from a 4-step warm state, one step in float32 (g,
P, U within 5e-7, yr 5e-5, F 1e-4: the Pallas test's tolerances) and in
float64 (atol 1e-12, identical fluid maps), 27 float64 steps (steps 2-28,
which hold no order-dependent reseed step; atol 1e-10, identical fluid
maps), and one float32 and one float64 step at N = 384 from the bench's
warmed state (the float64 one at atol 1e-12); and the geometry tail's
window of fresh rows (fresh_map_kernel) against the plain per-cell test on
random walls at N = 384, four seeds in each type: identical maps.
14. decomposition (runs after phase 13, before phase 12's worker window) —
     each halo-in entry (step_fused_halo of sc, hcz, fakhari, scrt and
     combustion, step_fused_halo_3d of hcz3d: the family's kernel launched
     nsub times on a shard's halo-extended slab, combustion's in its slab
     mode) against its plain version on a 64-row shard's slab at ω ≠ 1,
     float32 over 5 sub-steps (the family's kernel tolerance) and float64
     over 20 (atol 1e-12), combustion also at 1 and 2 float32 sub-steps,
     flow only and in the lid cavity; the validation.multichip_check
     subcommands at their default sizes (4 shards on this card), with the
     narrow combustion case (128 × 20, 4 shards of 5 rows, nsub 1) also
     held against the halo entry's plain version on every shard's slab;
     then the decomposition's main path, every path at full width against
     the single-lattice kernel run of as many steps from the same state, max
     |diff| <= 1e-6 (0 expected: the same per-cell arithmetic; combustion
     over the cells where the model defines each field, and bit-identity
     reported):
     make_fused_hcz_step on RTI-2048 over 2 y shards (8194 rows do not
     divide by 4), nsub 5, 100 steps; make_fused_hcz_step_2d on RTI-2048
     over 2 × 2, nsub 2, 40 steps; make_fused_sc_step on the walled 2048² SC
     droplet (MRT, ω = 1.25) over 4 y shards, nsub 4, 100 steps;
     make_fused_sc_step_2d on it over 2 × 2, nsub 2, 40 steps;
     make_fused_fakhari_step on the 2048² bubble over 4 y shards, nsub 2,
     100 steps; make_fused_scrt_step on SC-RT 2048 × 8194 over 4 x shards,
     nsub 2, 100 steps; make_fused_hcz3d_step on the 128³ droplet over 4 z
     shards, nsub 2, 50 steps; make_fused_combustion_step on the 840 × 160
     channel after the bench's 2N warm-up over 4 y shards, nsub 2, 100
     steps.  Each prints its ms per step and MLUPS
     beside the single-lattice kernel's, the exchange's share of the step
     and the halo entries' time (CUDA events, not gated: shards on one card
     run one after another, so this measures overhead, not scaling).
Each kernel's counted steps (``kernel.steps.<family>`` of the recorder in
``utils/profiling``) are read from a zero taken just before its own main
path (phases 4-5, 5b, 6-8, 9, 10, 11, 13, 14, 12); the halo routes count
apart (``kernel.steps.<family>.halo``).  Then one JSON line with every kernel of
the paths, the layered channel's sc_step and the six halo routes
included (pulsatile_step's and hcz3d_step's entries also
with their launches_per_step from the N = 384 and 128³ profiles), and, last,
{"ok": true, "device": {...}}.
"""
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

F32_TOL = dict(rtol=2e-5, atol=2e-6)
F64_TOL = dict(rtol=0.0, atol=1e-12)
HCZ_F32_TOL = dict(rtol=3e-5, atol=3e-6)
HCZ3D_F32_TOL = dict(rtol=5e-5, atol=5e-6)
FAKHARI_F32_TOL = dict(rtol=5e-5, atol=5e-6)
SCRT_F32_TOL = dict(rtol=2e-5, atol=2e-6)
# pulsatile_step against the plain path, by field (tests/test_pallas_pulsatile_full.py)
PULSATILE_F32_TOL = {"g_coll": 5e-7, "g_stream": 5e-7, "P": 5e-7, "Ux": 5e-7,
                     "Uy": 5e-7, "F": 1e-4, "yr1": 5e-5, "yr2": 5e-5}
# combustion_step against the plain path: tighter than the Pallas test's
# rtol 2e-4, atol 5e-6 (tests/test_pallas_combustion.py); the largest
# float32 error measured on an H100 over 5 steps was 5.4e-7
COMBUSTION_F32_TOL = dict(rtol=2e-5, atol=2e-6)

# H100 SXM data sheet: 3.35 TB/s of device memory, 67 TFLOP/s float32
# outside the tensor cores (the kernels use none).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
# The work of one step in float32: the bytes it must move (each input read
# once, each output written once) and the floating-point operations it must
# do (each field formed once per cell), counted from the arithmetic of the
# step: the cells times the wrapper's WORK_PER_CELL (per_cell), or
# combustion_fused.step_work, which counts them from the lattice's flags.


# the step counts of the wrappers, read from the zero of :func:`_zero`
_ZEROS = {}


def _step_counter(mod, halo=False):
    return f"kernel.steps.{mod.FAMILY}" + (".halo" if halo else "")


def _zero(mod, halo=False):
    """Count ``mod``'s kernel steps from here on."""
    from multiphase_lbm_tpu_torch.utils import profiling
    _ZEROS[_step_counter(mod, halo)] = profiling.counter(_step_counter(mod, halo))


def _steps(mod, halo=False):
    """The kernel steps ``mod`` counted since :func:`_zero`."""
    from multiphase_lbm_tpu_torch.utils import profiling
    name = _step_counter(mod, halo)
    return profiling.counter(name) - _ZEROS.get(name, 0)


def per_cell(mod, cells):
    """(bytes, operations) of one step of ``mod``'s kernel on ``cells``
    cells."""
    return tuple(cells * v for v in mod.WORK_PER_CELL)


def bound(work, flop_rate=F32_FLOP_PER_S):
    """(bound_ms, bound_by): the least time the card could take for one
    step of ``work`` (bytes, operations), the larger of bytes over the
    memory rate and operations over ``flop_rate`` (float32's by default).
    For a state that fits in the 50 MB L2 (combustion at 420 × 80 and
    840 × 160) the bytes stay in L2 from step to step, so this device-memory
    bound is an upper estimate of the floor."""
    nbytes, flops = work
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the kernel of csrc/sc_step.cu (B1)
SC_KERNELS = ("sc_step_kernel",)
# the kernels of csrc/combustion_step.cu (B7)
CB_KERNELS = ("boundary_kernel", "fields_kernel", "collide_stream_kernel")
# the kernels of csrc/hcz3d_step.cu (B5)
B5_KERNELS = ("phi_kernel", "tile_kernel")
# the kernels of csrc/pulsatile_step.cu (B6); the last one serves checks
PB_KERNELS = ("links_kernel", "tile_kernel", "tail_kernel",
              "reseed_scatter_kernel", "fresh_map_kernel")


def ptxas_report(log, source, kernels):
    """``(kernel<type, flags>, registers, spill store bytes, spill load
    bytes)`` of each entry function of ``kernels`` of the source ``source``
    (the stem of a ``csrc/*.cu`` file, which its mangled names carry) in an
    ``nvcc -Xptxas -v`` log (empty when this process did not build); bool
    template arguments after the type are named true or false."""
    rows, name, spills = [], None, (None, None)
    for line in (log or "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(" + "|".join(kernels) + r")I([fd])((?:Lb[01]E)*)E",
                          m.group(1))
            k = k if source in m.group(1) else None
            args = ["float" if k and k.group(2) == "f" else "double"] + [
                "true" if b == "1" else "false"
                for b in re.findall(r"Lb([01])E", k.group(3) if k else "")]
            name = f"{k.group(1)}<{', '.join(args)}>" if k else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name = None
    return rows


def kernel_name(name):
    """The short name of a profiler kernel name: ``collide_stream_kernel<float>``
    or the last scope of a library kernel's name."""
    m = re.search(r"(\w+_kernel<\w+>)", name)
    return m.group(1) if m else name.split("<")[0].split("::")[-1]


def say(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_err_within(out, ref, rtol, atol):
    """(max |out − ref|, whether |out − ref| <= atol + rtol·|ref| everywhere)
    of a tensor or of a tuple of tensors."""
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    err, ok = 0.0, True
    for o, r in zip(out, ref):
        d = (o.double() - r.double()).abs()
        err = max(err, float(d.max()))
        ok = ok and bool(torch.isfinite(o).all()) and bool(
            (d <= atol + rtol * r.double().abs()).all())
    return err, ok


def compare(name, out, ref, tol, failures):
    """Print one kernel-against-plain line; note a failure."""
    torch.cuda.synchronize()
    err, ok = max_err_within(out, ref, **tol)
    say(f"[kernel vs plain] {name}: max abs err {err:.3e} "
        f"(rtol {tol['rtol']}, atol {tol['atol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return err


def run_cli(coolbm, argv, expected, outdir=None):
    """coolbm ``argv`` into ``outdir`` (default a temporary directory):
    returns the files it wrote after checking the exit code, the MLUPS line
    and the ``expected`` files."""
    with tempfile.TemporaryDirectory() as tmp:
        out = outdir or tmp
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = coolbm.main([*argv, "--outdir", out, "--device", "cuda"])
        say(buf.getvalue().strip())
        check(rc == 0, f"coolbm {argv} returned {rc}")
        produced = sorted(os.listdir(out))
        say(f"[cli] {argv[0]} wrote {produced}")
        for name in expected:
            check(name in produced, f"{name} not in {produced}")
        check("MLUPS" in buf.getvalue(), f"no MLUPS line from {argv}")
        return produced


def timed(module, name, **kwargs):
    """``(result, seconds)`` of ``name(**kwargs)`` of a validation module:
    a task of the worker processes of phase 12."""
    import importlib

    t0 = time.perf_counter()
    fn = getattr(importlib.import_module(
        f"multiphase_lbm_tpu_torch.validation.{module}"), name)
    out = fn(**kwargs)
    return out, time.perf_counter() - t0


def main():
    t_start = time.perf_counter()
    # ---- 1. device ----
    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
            "is False); the port's kernels need one")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    say(card.splitlines()[0])
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    from multiphase_lbm_tpu_torch import bench
    from multiphase_lbm_tpu_torch.models import combustion as cbm
    from multiphase_lbm_tpu_torch.models import fakhari as fk
    from multiphase_lbm_tpu_torch.models import hcz
    from multiphase_lbm_tpu_torch.models import pulsatile as pm
    from multiphase_lbm_tpu_torch.models import shan_chen as sc
    from multiphase_lbm_tpu_torch.models import shan_chen_rt as rt
    from multiphase_lbm_tpu_torch.ops import _build, hcz3d_fused, hcz_fused
    from multiphase_lbm_tpu_torch.ops import fakhari_fused, sc_fused, scrt_fused
    from multiphase_lbm_tpu_torch.ops import combustion_fused, pulsatile_fused
    from multiphase_lbm_tpu_torch.runners import coolbm
    from multiphase_lbm_tpu_torch.validation import rti_regression
    from multiphase_lbm_tpu_torch.validation import pulsatile_fullrun
    from multiphase_lbm_tpu_torch.validation import combustion_reference
    from multiphase_lbm_tpu_torch.validation import multichip_check as mc
    from multiphase_lbm_tpu_torch.validation import scrt_reference
    from multiphase_lbm_tpu_torch.validation import womersley
    from multiphase_lbm_tpu_torch.validation import layered_poiseuille
    from multiphase_lbm_tpu_torch.utils.profiling import measure_mlups_slope

    # ---- 2. build ----
    _build.build()
    _build.load()
    say(f"[build] {_build.LIB_PATH.name} in {_build.build_seconds or 0.0:.1f} s"
        f" (0.0 = already current)")
    if _build.build_log:
        say(_build.build_log.strip())
    for name, regs, stores, loads in ptxas_report(
            _build.build_log, "sc_step", SC_KERNELS):
        say(f"[build] {name} (<type, periodic, const_g>): {regs} registers, "
            f"spill stores {stores} B, spill loads {loads} B")
    for name, regs, stores, loads in ptxas_report(
            _build.build_log, "hcz3d_step", B5_KERNELS):
        say(f"[build] {name} (hcz3d_step): {regs} registers, spill stores "
            f"{stores} B, spill loads {loads} B")

    # ---- 3. kernels against their plain versions ----
    failures = []
    for geometry in ("periodic", "walls"):
        nx, ny = (256, 256) if geometry == "periodic" else (256, 128)
        for collision in ("bgk", "mrt"):
            p = sc.SCParams(collision=collision, omega=1.25, rho_w=0.2)
            for dtype, steps, tol in ((torch.float32, 5, F32_TOL),
                                      (torch.float64, 20, F64_TOL)):
                if geometry == "periodic":
                    f = sc.init_droplet(nx, ny, p, radius=32.0, dtype=dtype,
                                        device=dev)
                    fluid = sc.geometry_periodic(nx, ny, device=dev)
                else:
                    f = sc.init_droplet(nx, ny, p, radius=32.0,
                                        center=(nx / 2, 5.0), dtype=dtype,
                                        device=dev)
                    fluid = sc.geometry_channel_walls(nx, ny, device=dev)
                    f = sc.apply_geometry(f, fluid)
                out = sc_fused.run_fused(f, fluid.to(torch.float32), p, steps,
                                         periodic=geometry == "periodic")
                ref = sc.run(f, fluid, p, steps)
                compare(f"sc_step {geometry} {nx}x{ny} {collision} "
                        f"omega=1.25 {str(dtype)[6:]} {steps} steps",
                        out, ref, tol, failures)

    def layered_params(**kw):
        """The constant-G layered channel's parameters (layered_poiseuille's
        EOS and densities) with a per-node force, p_shift as the CLI sets it."""
        p0 = sc.SCParams(TT0=0.95, rhol=0.21, rhog=0.067, rho_w=0.067,
                         psi_mode="const_g", G=-1.0, **kw)
        return dataclasses.replace(p0, p_shift=sc.compute_p_shift(p0))

    def sc_case(case, dtype):
        """(params, f, fluid, periodic) of the layered channel and of the
        lattices at the kernel tile's edges, at ω = 1.25."""
        if case.startswith("const_g layers"):
            p = layered_params(collision=case.split()[-1], omega=1.25,
                               gx_u=1e-6, gy_u=-3e-7)
            fluid = sc.geometry_channel_walls(64, 64, device=dev)
            f = sc.init_layers(64, 64, p, dtype=dtype, device=dev)
            return p, sc.apply_geometry(f, fluid), fluid, False
        nx, ny = {"channel 45x37": (45, 37), "channel 3x5": (3, 5),
                  "periodic 7x2": (7, 2), "obstacle 45x37": (45, 37)}[case]
        p = sc.SCParams(collision="mrt", omega=1.25, rho_w=0.2,
                        gravity=1e-5, gx=-2e-5)
        if case == "periodic 7x2":
            f = sc.init_droplet(nx, ny, p, radius=2.0, dtype=dtype, device=dev)
            return p, f, sc.geometry_periodic(nx, ny, device=dev), True
        f = sc.init_droplet(nx, ny, p, radius=nx / 4, center=(nx / 2, 3.0),
                            dtype=dtype, device=dev)
        fluid = sc.geometry_channel_walls(nx, ny, device=dev)
        if case == "obstacle 45x37":           # across x = 32 and y = 8
            fluid[5:12, 28:36] = False
        return p, sc.apply_geometry(f, fluid), fluid, False

    err_layers = 0.0
    for case in ("const_g layers bgk", "const_g layers mrt", "channel 45x37",
                 "channel 3x5", "periodic 7x2", "obstacle 45x37"):
        for dtype, steps, tol in ((torch.float32, 5, F32_TOL),
                                  (torch.float64, 20, F64_TOL)):
            p, f, fluid, periodic = sc_case(case, dtype)
            out = sc_fused.run_fused(f, fluid.to(torch.float32), p, steps,
                                     periodic=periodic)
            ref = sc.run(f, fluid, p, steps)
            shape = "x".join(map(str, reversed(fluid.shape)))
            err = compare(f"sc_step {case} {shape} omega=1.25 "
                          f"{str(dtype)[6:]} {steps} steps", out, ref, tol,
                          failures)
            if case == "const_g layers mrt" and dtype == torch.float64:
                err_layers = err
    n = 2048
    err_sc = 0.0
    for omega in (1.0, 1.25):
        p = sc.SCParams(collision="mrt", omega=omega)
        f = sc.init_droplet(n, n, p, radius=n / 8.0, dtype=torch.float32,
                            device=dev)
        fluid = sc.geometry_periodic(n, n, device=dev)
        out = sc_fused.run_fused(f, fluid.to(torch.float32), p, 5,
                                 periodic=True)
        ref = sc.run(f, fluid, p, 5)
        err_sc = max(err_sc, compare(
            f"sc_step periodic {n}x{n} mrt omega={omega} float32 5 steps",
            out, ref, F32_TOL, failures))
        del f, fluid, out, ref

    def hcz_case(case, dtype, N=256):
        small = {"channel 45x37": (45, 37), "channel 3x5": (3, 5),
                 "periodic 7x2": (7, 2), "obstacle 45x37": (45, 37)}
        if case in small:
            nx, ny = small[case]
            p = hcz.HCZParams(omega=1.25, gravity=-1e-5, kappa=0.01)
            fluid = hcz.geometry_channel(nx, ny, device=dev)
            if case == "periodic 7x2":
                fluid[:] = True
            if case == "obstacle 45x37":       # across x = 32 and y = 8
                fluid[5:12, 28:36] = False
            st = hcz.init_rayleigh_taylor(nx, ny, p, dtype=dtype, device=dev)
            return p, hcz.apply_geometry(st, fluid), fluid
        if case == "layers":
            p = hcz.HCZParams(omega=1.25, kappa=0.001, Gx_const=1e-8)
            fluid = hcz.geometry_channel(128, 128, device=dev)
            st = hcz.init_layers(128, 128, p, dtype=dtype, device=dev)
            return p, hcz.apply_geometry(st, fluid), fluid
        p, st, fluid = rti_regression.rti_state(N, dev, dtype)
        if case == "rti omega=1.25":
            p = dataclasses.replace(p, omega=1.25)
        return p, st, fluid

    for case in ("rti omega=1.25", "rti omega=1.96 (config)", "layers",
                 "channel 45x37", "channel 3x5", "periodic 7x2",
                 "obstacle 45x37"):
        for dtype, steps, tol in ((torch.float32, 5, HCZ_F32_TOL),
                                  (torch.float64, 20, F64_TOL)):
            p, st, fluid = hcz_case(case, dtype)
            out = hcz_fused.run_fused(*st, fluid.to(torch.float32), p, steps)
            ref = hcz.run(st, fluid, p, steps)
            shape = "x".join(map(str, reversed(fluid.shape)))
            compare(f"hcz_step {case} {shape} omega={p.omega:.4g} "
                    f"{str(dtype)[6:]} {steps} steps", out, ref, tol, failures)
    p, st, fluid = rti_regression.rti_state(2048, dev)
    out = hcz_fused.run_fused(*st, fluid.to(torch.float32), p, 5)
    ref = hcz.run(st, fluid, p, 5)
    err_hcz = compare(f"hcz_step RTI-2048 2048x8194 omega={p.omega:.4g} "
                      "float32 5 steps", out, ref, HCZ_F32_TOL, failures)
    del st, fluid, out, ref

    p3 = hcz.HCZParams(omega=1.2, kappa=5e-4)
    # the 64³ droplet; a box that is not a multiple of the kernel's 32 × 8
    # tile or of its 16-plane chunk, and one thinner in z than its 7-plane
    # φ window (nx × ny × nz)
    for nx3, ny3, nz3 in ((64, 64, 64), (37, 11, 9), (33, 9, 3)):
        radius = None if nx3 == 64 else min(nx3, ny3, nz3) / 3.0
        fluid3 = hcz.geometry_periodic_3d(nx3, ny3, nz3, device=dev)
        for dtype, steps, tol in ((torch.float32, 5, HCZ3D_F32_TOL),
                                  (torch.float64, 20, F64_TOL)):
            st = hcz.init_droplet_3d(nx3, ny3, nz3, p3, radius=radius,
                                     dtype=dtype, device=dev)
            out = hcz3d_fused.run_fused_3d(*st, p3, steps)
            ref = hcz.run(st, fluid3, p3, steps, lattice=hcz.D3Q19,
                          three_d=True)
            compare(f"hcz3d_step droplet {nx3}x{ny3}x{nz3} omega=1.2 "
                    f"{str(dtype)[6:]} {steps} steps", out, ref, tol, failures)
    st = hcz.init_droplet_3d(128, 128, 128, p3, dtype=torch.float32,
                             device=dev)
    out = hcz3d_fused.run_fused_3d(*st, p3, 3)
    ref = hcz.run(st, hcz.geometry_periodic_3d(128, 128, 128, device=dev), p3,
                  3, lattice=hcz.D3Q19, three_d=True)
    err_hcz3d = compare("hcz3d_step droplet 128^3 omega=1.2 float32 3 steps",
                        out, ref, HCZ3D_F32_TOL, failures)
    del st, out, ref

    for tau in (0.8, 0.55):
        pf = fk.FakhariParams(tau=tau)
        for dtype, steps, tol in ((torch.float32, 5, FAKHARI_F32_TOL),
                                  (torch.float64, 20, F64_TOL)):
            st = fk.init_bubble(128, 128, pf, dtype=dtype, device=dev)
            out = fakhari_fused.run_fused(*st, pf, steps)
            ref = fk.run(st, pf, steps)
            compare(f"fakhari_step bubble 128x128 tau={tau} "
                    f"{str(dtype)[6:]} {steps} steps", out, ref, tol, failures)
    pf = fk.FakhariParams()
    st = fk.init_bubble(n, n, pf, dtype=torch.float32, device=dev)
    out = fakhari_fused.run_fused(*st, pf, 5)
    ref = fk.run(st, pf, 5)
    err_fakhari = compare(f"fakhari_step bubble {n}x{n} tau=0.8 float32 "
                          "5 steps", out, ref, FAKHARI_F32_TOL, failures)
    del st, out, ref

    def scrt_case(nx, omega, dtype):
        pr = rt.SCRTParams(omega=omega)
        fluid = rt.geometry_channel(nx, 4 * nx + 2, device=dev)
        f = rt.init_interface(nx, 4 * nx + 2, pr, dtype=dtype,
                              device=dev) * fluid[None]
        return pr, f, fluid

    for omega in (1.0, 1.25):
        for dtype, steps, tol in ((torch.float32, 5, SCRT_F32_TOL),
                                  (torch.float64, 20, F64_TOL)):
            pr, f, fluid = scrt_case(128, omega, dtype)
            out = scrt_fused.run_fused(f, pr, steps)
            ref = rt.run(f, fluid, pr, steps)
            compare(f"scrt_step channel 128x514 omega={omega} "
                    f"{str(dtype)[6:]} {steps} steps", out, ref, tol, failures)
    pr, f, fluid = scrt_case(n, 1.0, torch.float32)
    out = scrt_fused.run_fused(f, pr, 5)
    ref = rt.run(f, fluid, pr, 5)
    err_scrt = compare(f"scrt_step channel {n}x{4 * n + 2} omega=1.0 float32 "
                       "5 steps", out, ref, SCRT_F32_TOL, failures)
    del f, fluid, out, ref

    def pulsatile_case(name, out, ref, tol):
        """One pulsatile_step-against-plain line: every field within its
        tolerance (a dict by field, or one atol) and identical fluid maps."""
        torch.cuda.synchronize()
        errs = {k: float((getattr(out, k).double() - getattr(ref, k).double())
                         .abs().max()) for k in PULSATILE_F32_TOL}
        same = bool(torch.equal(out.fluid, ref.fluid))
        lim = tol if isinstance(tol, dict) else dict.fromkeys(errs, tol)
        ok = same and all(errs[k] < lim[k] for k in errs)
        say(f"[kernel vs plain] pulsatile_step {name}: max abs err "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; fluid maps {'identical' if same else 'DIFFER'} "
            f"(tolerance {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"pulsatile_step {name}")
        return max(errs[k] for k in ("g_coll", "g_stream", "P", "Ux", "Uy"))

    pp = pm.PulsatileParams(nx=621, ny=64)
    for dtype, tol in ((torch.float32, PULSATILE_F32_TOL),
                       (torch.float64, 1e-12)):
        st = pm.run(pm.initialize(pp, dtype, device=dev), 0, pp, 4)
        ref, (n_dep, n_cells) = pm.run_with_diag(st, 4, pp, 1)
        out, diag = pulsatile_fused.run_fused_full(st, 4, pp, 1)
        pulsatile_case(f"621x64 {str(dtype)[6:]} 1 step from step 4", out, ref,
                       tol)
        check(diag.tolist() == [0, n_cells] and n_dep == 0,
              f"pulsatile diag {diag.tolist()} against the plain path's "
              f"{[n_dep, n_cells]}")
    st = pm.run(pm.initialize(pp, torch.float64, device=dev), 0, pp, 2)
    ref, (n_dep, _) = pm.run_with_diag(st, 2, pp, 27)
    out, diag = pulsatile_fused.run_fused_full(st, 2, pp, 27)
    check(n_dep == 0 and int(diag[0]) == 0,
          "an order-dependent reseed step in the 27-step window")
    pulsatile_case("621x64 float64 27 steps (steps 2-28)", out, ref, 1e-10)
    pbig, st, t_big = bench.pulsatile_warm_state(384, dev)
    ref = pm.run(st, t_big, pbig, 1)
    out, _ = pulsatile_fused.run_fused_full(st, t_big, pbig, 1)
    err_pulsatile = pulsatile_case(
        f"{pbig.nx}x{pbig.ny} float32 1 step from the bench's warm state",
        out, ref, PULSATILE_F32_TOL)
    st = st._replace(**{k: getattr(st, k).double() for k in (
        "g_coll", "g_stream", "yr1", "yr2", "P", "Ux", "Uy")})
    F = pm.fobj_from_walls(st.yr1, st.yr2, pbig)
    st = st._replace(F=F, fluid=pm.flags_from_fobj(F, pbig))
    ref = pm.run(st, t_big, pbig, 1)
    out, _ = pulsatile_fused.run_fused_full(st, t_big, pbig, 1)
    pulsatile_case(f"{pbig.nx}x{pbig.ny} float64 1 step from the bench's "
                   "warm state", out, ref, 1e-12)
    del st, ref, out
    # the geometry tail's window of fresh rows against the per-cell test
    for dtype in (torch.float32, torch.float64):
        for seed in range(4):
            yr, yr_new = pulsatile_fused.random_walls(pbig, dtype, seed)
            same = torch.equal(
                pulsatile_fused.fresh_map(yr.to(dev), yr_new.to(dev), pbig)
                .cpu(), pulsatile_fused.fresh_map_plain(yr, yr_new, pbig))
            say(f"[kernel vs plain] pulsatile fresh_map_kernel "
                f"{pbig.nx}x{pbig.ny} {str(dtype)[6:]} random walls seed "
                f"{seed}: {'identical' if same else 'DIFFER'}")
            if not same:
                failures.append(f"pulsatile fresh map {dtype} seed {seed}")
    if failures:
        raise SystemExit(f"kernel disagrees with the plain path: {failures}")

    # ---- 4. SC main path: the headline ----
    rec_plain, rd_plain, _ = bench.run(size=n, steps=10, steps2=30, plain=True)
    say(f"[bench plain] {json.dumps(rec_plain)}")
    check(rd_plain.valid, rec_plain)
    del rd_plain
    _zero(sc_fused)              # count the main path's steps only
    rec, rd, f0 = bench.run(size=n, steps=200, steps2=600)
    say(f"[bench kernel] {json.dumps(rec)}")
    check(rd.valid, rec)
    # the profile in a process of its own: phase 12's profiles here count
    # each kernel's launches a step, and with one more profiler session in
    # this process one of them counted 98 of its 100 link launches
    res = subprocess.run([sys.executable, "-m", "multiphase_lbm_tpu_torch.bench",
                          "--profile", "20"], capture_output=True, text=True,
                         timeout=600, check=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    prof = json.loads(res.stdout.strip().splitlines()[-1])["profile"]
    say(f"[profile] sc {n}x{n} (bench --profile 20): " + ", ".join(
        f"{kernel_name(k['name'])} {k['ms_per_step']:.5f} ms "
        f"({k['calls_per_step']:g} a step)" for k in prof["kernels"])
        + f"; busy {prof['device_busy_ms_per_step']:.5f} ms a step, idle "
        f"{100 * prof['idle_share']:.1f}% under the profiler, on {card}")
    bench_launches = _steps(sc_fused)
    check(bench_launches > 0, "the headline did not launch the kernel")
    out = rd.out
    check(bool(torch.isfinite(out).all()), "non-finite state")
    m0 = float(f0.double().sum())
    m1 = float(out.double().sum())
    drift = abs(m1 - m0) / m0
    rho = sc.density(out)
    rho_in = float(rho[n // 2, n // 2])
    rho_out = float(rho[8, 8])
    say(f"[physics] mass drift {drift:.3e} (< 1e-4), rho centre {rho_in:.4f} "
        f"(0.265 +-10%), rho far {rho_out:.4f} (0.038 +-10%)")
    check(drift < 1e-4, f"mass drift {drift}")
    check(abs(rho_in - 0.265) <= 0.1 * 0.265, f"rho centre {rho_in}")
    check(abs(rho_out - 0.038) <= 0.1 * 0.038, f"rho far {rho_out}")
    say(f"[main path] kernel {rec['value']:.1f} MLUPS vs plain "
        f"{rec_plain['value']:.1f} MLUPS at {n}x{n} MRT float32 on {card}")
    del out, rho, rd, f0

    # ---- 5. SC CLI ----
    run_cli(coolbm, ["laplace2D_sc", "--f32", "--steps", "800"],
            ("sol_0000000.vtk", "sol_0000400.vtk", "mass.dat", "energy.dat"))
    check(_steps(sc_fused) > bench_launches, "the CLI did not launch the kernel")
    sc_launches = _steps(sc_fused)

    # ---- 5b. SC layered channel: the gate, the CLI, the step's time ----
    _zero(sc_fused)              # count the layered path's steps only
    t0 = time.perf_counter()
    _, _, err_lp = layered_poiseuille.run()        # 64², 40,000 float64 steps
    secs = time.perf_counter() - t0
    say(f"[gate] layered_poiseuille 64x64 40000 float64 steps through sc_step:"
        f" max relative deviation {err_lp:.4f} (< {layered_poiseuille.GATE}),"
        f" {secs:.2f} s wall, {_steps(sc_fused)} launches")
    check(_steps(sc_fused) >= 40000, "the layered gate did not launch sc_step")
    check(err_lp < layered_poiseuille.GATE,
          f"layered Poiseuille deviation {err_lp}")
    before = _steps(sc_fused)
    run_cli(coolbm, ["twoLayeredFlow2D_sc", "--steps", "400"],
            ("sol_0000000.vtk", "energy.dat", "mass.dat"))
    check(_steps(sc_fused) > before, "twoLayeredFlow2D_sc did not launch "
          "the kernel")
    p_l = layered_params(gx_u=1e-6)
    fl_l = sc.geometry_channel_walls(64, 64, device=dev)
    f_l = sc.apply_geometry(sc.init_layers(64, 64, p_l, device=dev), fl_l)
    m_l = fl_l.to(torch.float32)
    rd_l = measure_mlups_slope(
        lambda k: (lambda v: sc_fused.run_fused(v, m_l, p_l, k)), f_l, 2000,
        6000, 64 * 64)
    rd_lp = measure_mlups_slope(lambda k: (lambda v: sc.run(v, fl_l, p_l, k)),
                                f_l, 5, 15, 64 * 64)
    check(rd_l.valid and rd_lp.valid, "invalid layered slope reading")
    layered_launches = _steps(sc_fused)
    say(f"[main path] layered channel 64x64 float64: kernel "
        f"{rd_l.ms_per_step:.5f} ms per step vs plain {rd_lp.ms_per_step:.3f}"
        f" ms; {layered_launches} sc_step launches on this path, on {card}")
    del f_l

    # ---- 6. RTI main path: RTI-2048 ----
    rec_rti_plain, rd, _ = bench.run(model="rti", steps=2, steps2=6,
                                     plain=True)
    say(f"[bench rti plain] {json.dumps(rec_rti_plain)}")
    check(rd.valid, rec_rti_plain)
    del rd
    _zero(hcz_fused)             # count the RTI path's steps only
    rec_rti, rd, st0 = bench.run(model="rti", steps=50, steps2=150)
    say(f"[bench rti kernel] {json.dumps(rec_rti)}")
    check(rd.valid, rec_rti)
    check(_steps(hcz_fused) > 0, "RTI-2048 did not launch the kernel")
    check(all(bool(torch.isfinite(t).all()) for t in rd.out),
          "non-finite RTI state")
    m0 = float(st0[0].double().sum())
    drift = abs(float(rd.out[0].double().sum()) - m0) / m0
    say(f"[physics] RTI-2048 phase-mass drift {drift:.3e} (< 1e-4)")
    check(drift < 1e-4, f"RTI phase-mass drift {drift}")
    say(f"[main path] kernel {rec_rti['value']:.1f} MLUPS vs plain "
        f"{rec_rti_plain['value']:.1f} MLUPS at RTI-2048 float32 on {card}")
    del rd, st0

    # ---- 7. literature gate: RTI at N = 256 to t = 2 ----
    t0 = time.perf_counter()
    times, spikes, bubbles = rti_regression.run_regression(t_end=2.0, N=256,
                                                           device=dev)
    secs = time.perf_counter() - t0
    ds, db, dvs, dvb = rti_regression.deviations(times, spikes, bubbles, 256)
    say(f"[literature] N=256 t=2 ({len(times)} samples, {secs:.2f} s): "
        f"spike {ds:.4f}, bubble {db:.4f} (< 0.15); spike velocity "
        f"{dvs:.4f}, bubble velocity {dvb:.4f} (< 0.25)")
    check(ds < 0.15 and db < 0.15 and dvs < 0.25 and dvb < 0.25,
          "RTI at N=256 departs from the published curves")

    # ---- 8. RTI CLI ----
    before_cli = _steps(hcz_fused)
    run_cli(coolbm, ["rayleighTaylor2D", "--f32", "--steps", "6400"],
            ("sol_0000000.vtk", "sol_0003200.vtk", "energy.dat",
             "spike_bubble_position.dat", "spike_bubble_velocity.dat"))
    hcz_launches = _steps(hcz_fused)
    check(hcz_launches > before_cli, "the RTI CLI did not launch the kernel")

    # ---- 9. 3D main path: the 128³ droplet and the laplace3D CLI ----
    rec_3d_plain, rd, _ = bench.run(model="hcz3d", steps=2, steps2=6,
                                    plain=True)
    say(f"[bench hcz3d plain] {json.dumps(rec_3d_plain)}")
    check(rd.valid, rec_3d_plain)
    del rd
    _zero(hcz3d_fused)           # count the 3D path's steps only
    rec_3d, rd, st0 = bench.run(model="hcz3d", steps=50, steps2=150)
    say(f"[bench hcz3d kernel] {json.dumps(rec_3d)}")
    check(rd.valid, rec_3d)
    check(all(bool(torch.isfinite(t).all()) for t in rd.out),
          "non-finite 3D state")
    m0 = float(st0[0].double().sum())
    drift = abs(float(rd.out[0].double().sum()) - m0) / m0
    say(f"[physics] 128^3 droplet phase-mass drift {drift:.3e} (< 1e-4)")
    check(drift < 1e-4, f"3D phase-mass drift {drift}")
    bench3d_launches = _steps(hcz3d_fused)
    check(bench3d_launches > 0, "the 3D bench did not launch the kernel")
    del rd, st0
    # B5's launches a step, from a profile in a process of its own (see
    # phase 4)
    res = subprocess.run([sys.executable, "-m", "multiphase_lbm_tpu_torch.bench",
                          "--model", "hcz3d", "--profile", "20"],
                         capture_output=True, text=True, timeout=600,
                         check=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    rec_3d_prof = json.loads(res.stdout.strip().splitlines()[-1])
    prof = rec_3d_prof["profile"]
    say(f"[profile] hcz3d 128^3 (bench --model hcz3d --profile 20, "
        f"{rec_3d_prof['ms_per_step']:.5f} ms a step by its slope): " + ", ".join(
        f"{kernel_name(k['name'])} {k['ms_per_step']:.5f} ms "
        f"({k['calls_per_step']:g} a step)" for k in prof["kernels"])
        + f"; busy {prof['device_busy_ms_per_step']:.5f} ms a step, idle "
        f"{100 * prof['idle_share']:.1f}% under the profiler, on {card}")
    hcz3d_per_step = sum(k["calls_per_step"] for k in prof["kernels"]
                         if any(f"{n}<" in k["name"] for n in B5_KERNELS))
    check(hcz3d_per_step == hcz3d_fused.LAUNCHES_PER_STEP,
          f"hcz3d_step launched {hcz3d_per_step} kernels a step, not "
          f"{hcz3d_fused.LAUNCHES_PER_STEP}")
    run_cli(coolbm, ["laplace3D", "--f32", "--steps", "200"],
            ("sol_0000000.vtk", "sol_0000100.vtk", "energy.dat"))
    check(_steps(hcz3d_fused) > bench3d_launches,
          "the laplace3D CLI did not launch the kernel")
    hcz3d_launches = _steps(hcz3d_fused)

    # ---- 10. Fakhari main path: the 2048² bubble ----
    rec_fk_plain, rd, _ = bench.run(model="fakhari", steps=2, steps2=6,
                                    plain=True)
    say(f"[bench fakhari plain] {json.dumps(rec_fk_plain)}")
    check(rd.valid, rec_fk_plain)
    del rd
    _zero(fakhari_fused)         # count the Fakhari path's steps only
    rec_fk, rd, st0 = bench.run(model="fakhari", steps=100, steps2=300)
    say(f"[bench fakhari kernel] {json.dumps(rec_fk)}")
    check(rd.valid, rec_fk)
    check(_steps(fakhari_fused) > 0, "the Fakhari bench did not launch the kernel")
    check(all(bool(torch.isfinite(t).all()) for t in rd.out),
          "non-finite Fakhari state")
    m0 = float(st0[0].double().sum())
    drift = abs(float(rd.out[0].double().sum()) - m0) / m0
    say(f"[physics] Fakhari {n}^2 sum(phi) drift {drift:.3e} (< 1e-4)")
    check(drift < 1e-4, f"Fakhari phase drift {drift}")
    say(f"[main path] kernel {rec_fk['value']:.1f} MLUPS vs plain "
        f"{rec_fk_plain['value']:.1f} MLUPS at the Fakhari bubble {n}x{n} "
        f"float32 on {card}")
    del rd, st0
    pf = fk.FakhariParams()
    st = fk.init_bubble(64, 64, pf, dtype=torch.float64, device=dev)
    m0 = float(fk.total_mass(st, pf))
    st = fakhari_fused.run_fused(*st, pf, 2000)
    C = fk.phase_field(st).cpu().numpy()
    rho = pf.rhol + C * (pf.rhoh - pf.rhol)
    pphys = fk.pressure(st).cpu().numpy() * rho / 3.0
    dp = float(pphys[32, 32] - pphys[2, 2])
    expected = pf.sigma / 8.0
    mdrift = abs(float(fk.total_mass(st, pf)) - m0) / m0
    say(f"[physics] Fakhari Laplace 64^2 float64 2000 steps: dP {dp:.4e} vs "
        f"sigma/R {expected:.4e} (within 35%), mass drift {mdrift:.2e} "
        f"(< 1e-12), bubble phi {C[32, 32]:.3e} (< 0.05), bulk {C[2, 2]:.4f}")
    check(dp > 0 and abs(dp - expected) / expected < 0.35,
          f"Fakhari Laplace jump {dp} against {expected}")
    check(mdrift < 1e-12, f"Fakhari mass drift {mdrift}")
    check(C[32, 32] < 0.05 and C[2, 2] > 0.95, "the Fakhari bubble moved")
    del st
    before_cli = _steps(fakhari_fused)
    run_cli(coolbm, ["Young_Laplace2D", "--f32", "--steps", "2000"],
            ("sol_0000000.vtk", "sol_0001000.vtk", "energy.dat", "mass.dat"))
    fakhari_launches = _steps(fakhari_fused)
    check(fakhari_launches > before_cli,
          "the Young_Laplace2D CLI did not launch the kernel")

    # ---- 11. SC-RT main path: 2048 × 8194 ----
    rec_rt_plain, rd, _ = bench.run(model="scrt", steps=2, steps2=6,
                                    plain=True)
    say(f"[bench scrt plain] {json.dumps(rec_rt_plain)}")
    check(rd.valid, rec_rt_plain)
    del rd
    _zero(scrt_fused)            # count the SC-RT path's steps only
    rec_rt, rd, f0 = bench.run(model="scrt", steps=100, steps2=300)
    say(f"[bench scrt kernel] {json.dumps(rec_rt)}")
    check(rd.valid, rec_rt)
    check(_steps(scrt_fused) > 0, "the SC-RT bench did not launch the kernel")
    check(bool(torch.isfinite(rd.out).all()), "non-finite SC-RT state")
    m0 = float(f0.double().sum())
    drift = abs(float(rd.out.double().sum()) - m0) / m0
    say(f"[physics] SC-RT {n}x{4 * n + 2} mass drift {drift:.3e} (< 1e-4)")
    check(drift < 1e-4, f"SC-RT mass drift {drift}")
    say(f"[main path] kernel {rec_rt['value']:.1f} MLUPS vs plain "
        f"{rec_rt_plain['value']:.1f} MLUPS at SC-RT {n}x{4 * n + 2} float32 "
        f"on {card}")
    del rd, f0
    rows = scrt_reference.compare(device=dev)
    for step, row in rows.items():
        gated = step in scrt_reference.GATED_STEPS
        say(f"[capture] SC-RT N=128 float64 step {step}: max |drho| col0 "
            f"{row['col0']:.3e}, colmid {row['colmid']:.3e} "
            f"({'< 5e-5' if gated else 'not gated'}); spike/bubble rows "
            f"{row['spike']:.0f}/{row['bubble']:.0f}, capture "
            f"{row.get('ref_spike', '-')}/{row.get('ref_bubble', '-')}")
        if gated:
            check(row["col0"] < scrt_reference.ATOL
                  and row["colmid"] < scrt_reference.ATOL,
                  f"SC-RT departs from the C++ capture at step {step}: {row}")
    before_cli = _steps(scrt_fused)
    run_cli(coolbm, ["RayleighTaylor2D_sc", "--f32", "--steps", "200"],
            ("sol_0000000.vtk", "sol_0000100.vtk", "energy.dat", "mass.dat",
             "spike_bubble_position.dat"))
    check(_steps(scrt_fused) > before_cli,
          "the RayleighTaylor2D_sc CLI did not launch the kernel")
    scrt_launches = _steps(scrt_fused)

    # ---- 13. combustion (before phase 12's worker window) ----
    t13 = time.perf_counter()
    cb_failures = []

    def cb_compare(name, out, ref, p, tol):
        """combustion_step against the plain path, each field over the cells
        where the model defines it (cbm.defined_values: the plain path holds
        NaN in the forcing terms at solid cells)."""
        flags, _ = cbm.build_geometry(p)
        a, b = cbm.defined_values(out, flags), cbm.defined_values(ref, flags)
        return compare(f"combustion_step {name}", tuple(a.values()),
                       tuple(b.values()), tol, cb_failures)

    mrt = dict(tau_flow=0.8, w_e=1.1, w_eps=1.2, w_q=1.3)
    bgk = dict(tau_flow=0.8, w_e=1.25, w_eps=1.25, w_q=1.25)
    live = dict(Y_O2_ini=0.22)
    cb_cases = [
        ("(a) channel 137x45 li2014 default tau",
         dict(nx=137, ny=45, **live), {}),
        ("(b) channel 137x45 full flow MRT", dict(nx=137, ny=45, **live, **mrt),
         {}),
        ("(c) (b) first_step", dict(nx=137, ny=45, **live, **mrt),
         dict(first_step=True)),
        ("(d) (b) flow only", dict(nx=137, ny=45, **live, **mrt),
         dict(konv=False)),
        ("(e) scheme none, no solid reaction",
         dict(nx=137, ny=45, conj_scheme="none", solid_reaction=False, **live),
         {}),
        ("(f) cavity 64x32", dict(nx=64, ny=32, topology="cavity", u_lid=0.05,
                                  **live, **mrt), {}),
        ("(f) couette 64x32 flow only",
         dict(nx=64, ny=32, topology="couette", u_lid=0.04, **mrt),
         dict(konv=False)),
        ("(f) poiseuille 64x32 flow only",
         dict(nx=64, ny=32, topology="poiseuille", dpdx=1e-6, tau_flow=0.8),
         dict(konv=False)),
        ("(g) channel 8x5", dict(nx=8, ny=5, **live, **mrt), {}),
        ("(g) channel 12x6", dict(nx=12, ny=6, **live, **mrt), {}),
        ("(g) channel 5x5", dict(nx=5, ny=5, **live, **mrt), {}),
        ("(h) every collision factor distinct",
         dict(nx=137, ny=45, **live, **mrt, tau_O2=0.9, tau_CO2=1.1,
              tau_T=0.7, tau_T_solid=1.4), {}),
        ("(h) flow rates equal at 1.25", dict(nx=137, ny=45, **live, **bgk),
         {}),
        ("(h) poiseuille 64x32 flow rates equal at 1.25 flow only",
         dict(nx=64, ny=32, topology="poiseuille", dpdx=1e-6, **bgk),
         dict(konv=False)),
    ]
    cb_errs = {}
    for name, kw, run_kw in cb_cases:
        pc = cbm.CombustionParams(**kw)
        for dtype, steps, tol in ((torch.float32, 5, COMBUSTION_F32_TOL),
                                  (torch.float64, 20, F64_TOL)):
            flags, _ = cbm.build_geometry(pc)
            st = cbm.initialize(pc, dtype, T_solid=1.8, flags=flags, device=dev)
            st = combustion_fused.run_fused(st, pc, 10, first_step=True)
            out = combustion_fused.run_fused(st, pc, steps, **run_kw)
            ref = cbm.run(st, pc, steps, **run_kw)
            cb_errs[(name, dtype)] = cb_compare(
                f"{name} {str(dtype)[6:]} {steps} steps", out, ref, pc, tol)
    err_cb = 0.0
    # the main path's shapes: 420 × 80 and 840 × 160 with all four
    # populations, and 420 × 80 flow only (its own code path: one launch a
    # step, whose collision applies the flow outlet and forms ρ and u
    # itself)
    for size, konvs in ((420, (True, False)), (840, (True,))):
        pc = bench.combustion_params(size)
        st = bench.combustion_state(pc, dev)
        for konv in konvs:
            out = combustion_fused.run_fused(st, pc, 5, konv=konv)
            ref = cbm.run(st, pc, 5, konv=konv)
            e = cb_compare(f"{pc.nx}x{pc.ny} {'konv' if konv else 'flow only'}"
                           " float32 5 steps from the bench's warm state", out,
                           ref, pc, COMBUSTION_F32_TOL)
            if size == 420 and konv:
                err_cb = e
            del out, ref
        del st
    say("[kernel vs plain] combustion_step largest float32 error "
        f"{max(v for (_, d), v in cb_errs.items() if d == torch.float32):.3e}"
        ", float64 "
        f"{max(v for (_, d), v in cb_errs.items() if d == torch.float64):.3e}")
    if cb_failures:
        raise SystemExit(f"combustion_step disagrees with the plain path: "
                         f"{cb_failures}")
    for name, regs, stores, loads in ptxas_report(
            _build.build_log, "combustion_step", CB_KERNELS):
        say(f"[build] {name}: {regs} registers, spill stores {stores} B, "
            f"spill loads {loads} B")
    rows = combustion_reference.compare(device=dev)
    for step, row in rows.items():
        say(f"[capture] combustion 128x48 float64 step {step}: " + ", ".join(
            f"{k} {v:.3e} (< {combustion_reference.FIELDS[k][0]:g})"
            for k, v in row.items()))
    check(combustion_reference.within(rows),
          "combustion departs from the C++ capture")
    rows32 = combustion_reference.compare(device=dev, dtype=torch.float32)
    for step, row in rows32.items():
        say(f"[capture] combustion 128x48 float32 step {step} (printed, not "
            "gated): " + ", ".join(f"{k} {v:.3e}" for k, v in row.items()))
    secs_cmp = time.perf_counter() - t13

    recs_cb = {}
    cb_cells = ((420, False), (840, False), (420, True))
    for size, flow_only in cb_cells:
        rec_p, rd, _ = bench.run(model="combustion", size=size, steps=2,
                                 steps2=6, plain=True, flow_only=flow_only)
        say(f"[bench combustion {size} {'flow only' if flow_only else 'konv'} "
            f"plain] {json.dumps(rec_p)}")
        check(rd.valid, rec_p)
        recs_cb[(size, flow_only)] = [rec_p]
        del rd
    _zero(combustion_fused)      # count the combustion path's steps only
    for size, flow_only in cb_cells:
        rec_k, rd, _ = bench.run(model="combustion", size=size, steps=200,
                                 steps2=600, flow_only=flow_only,
                                 profile_steps=20)
        what = "flow only" if flow_only else "konv"
        say(f"[bench combustion {size} {what} kernel] {json.dumps(rec_k)}")
        prof = rec_k["profile"]
        say(f"[profile] combustion {size} {what}: " + ", ".join(
            f"{kernel_name(k['name'])} {k['ms_per_step']:.5f} ms "
            f"({k['calls_per_step']:g} a step)" for k in prof["kernels"])
            + f"; busy {prof['device_busy_ms_per_step']:.5f} ms a step, idle "
            f"{100 * prof['idle_share']:.1f}%")
        check(rd.valid, rec_k)
        pc = bench.combustion_params(size)
        st = rd.out                    # bench.run checked it finite
        flags, _ = cbm.build_geometry(pc)
        tab = cbm.build_static_tables(flags, pc)
        fin, fout = (float(v) for v in cbm.mass_flux_audit(st, tab, pc))
        energy = float(cbm.thermal_energy(st, tab, pc))
        say(f"[physics] combustion {pc.nx}x{pc.ny} {what}: mass flux in "
            f"{fin:.6e}, out {fout:.6e} (both > 0), thermal energy "
            f"{energy:.6e} (finite)")
        check(fin > 0 and fout > 0, f"combustion mass flux {fin}, {fout}")
        check(math.isfinite(energy), f"combustion thermal energy {energy}")
        recs_cb[(size, flow_only)].insert(0, rec_k)
        bound_ms, _ = bound(combustion_fused.step_work(pc, not flow_only))
        say(f"[main path] kernel {rec_k['value']:.1f} MLUPS "
            f"({rec_k['ms_per_step']:.5f} ms per step, bound {bound_ms:.6f}"
            f" ms) vs plain "
            f"{recs_cb[(size, flow_only)][1]['value']:.3f} MLUPS "
            f"({recs_cb[(size, flow_only)][1]['ms_per_step']:.2f} ms per step)"
            f" at the combustion channel {pc.nx}x{pc.ny} {what} float32 on "
            f"{card}")
        del rd, st
    check(_steps(combustion_fused) > 0,
          "the combustion bench did not launch the kernel")
    before_cli = _steps(combustion_fused)
    with tempfile.TemporaryDirectory() as tmp:
        stage1, stage2 = os.path.join(tmp, "stage1"), os.path.join(tmp, "stage2")
        audit = ("inlet_massflow.dat", "inlet_massflow_names.dat",
                 "outlet_massflow.dat", "outlet_massflow_names.dat",
                 "inlet_momentumflow.dat", "inlet_momentumflow_names.dat",
                 "outlet_momentumflow.dat", "outlet_momentumflow_names.dat",
                 "massflow_Komp_inlet_outlet.dat",
                 "massflow_Komp_inlet_outlet_names.dat",
                 "conservation_totals.dat")
        files = run_cli(coolbm, ["combustion", "--f32", "--steps", "1000",
                                 "--scalar-steps", "500"],
                        ("ini_f.dat", "energy.dat", "thermal-energy.dat",
                         "conservation.dat") + audit, outdir=stage1)
        for prefix in ("sol_", "velocity_middleline_"):
            check(any(n.startswith(prefix) for n in files),
                  f"no {prefix}* from coolbm combustion")
        vtk = next(n for n in files if n.startswith("sol_"))
        with open(os.path.join(stage1, vtk)) as fh:
            check("velocity_Z" in fh.read(), "no velocity_Z in the VTK")
        run_cli(coolbm, ["combustion", "--f32", "--restart",
                         os.path.join(stage1, "ini_f.dat"), "--scalar-steps",
                         "200"], ("thermal-energy.dat", "conservation.dat"),
                outdir=stage2)
    run_cli(coolbm, ["combustion", "--f32", "--topology", "cavity", "--u-lid",
                     "0.01", "--steps", "1000", "--scalar-steps", "200"],
            ("thermal-energy.dat", "conservation.dat"))
    run_cli(coolbm, ["combustion", "--f32", "--bench"], ())
    check(_steps(combustion_fused) > before_cli,
          "the combustion CLI did not launch the kernel")
    combustion_launches = _steps(combustion_fused)
    say(f"[combustion] phase 13 {time.perf_counter() - t13:.1f} s "
        f"(kernel vs plain and the capture {secs_cmp:.1f} s)")

    # ---- 14. decomposition (before phase 12's worker window) ----
    t14 = time.perf_counter()
    for family in mc.HALO_ENTRIES:
        for dtype, nsub in ((torch.float32, 5), (torch.float64, 20)):
            res = mc.check_halo_entry(family, dtype, nsub, dev)
            torch.cuda.synchronize()
            ok = (res["ok"] and res["launched"] == nsub
                  and res["launched_main"] == 0)
            say(f"[kernel vs plain] {family} step_fused_halo {str(dtype)[6:]} "
                f"{nsub} sub-steps on a 64-row shard's slab: max abs err "
                f"{res['max_abs_err']:.3e} (rtol {res['tol']['rtol']}, atol "
                f"{res['tol']['atol']}), {res['launched']} halo launches "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"{family} step_fused_halo disagrees with its plain "
                  f"version: {res}")
    # all four populations (the channel's wall-row and outlet fixes at the
    # slab's global rows), flow only and the lid cavity
    for variant, dtype, nsub in (("konv", torch.float32, 1),
                                 ("konv", torch.float32, 2),
                                 ("konv", torch.float32, 5),
                                 ("konv", torch.float64, 20),
                                 ("flow", torch.float32, 5),
                                 ("flow", torch.float64, 20),
                                 ("cavity", torch.float32, 5),
                                 ("cavity", torch.float64, 20)):
        res = mc.check_halo_entry("combustion", dtype, nsub, dev, variant)
        torch.cuda.synchronize()
        ok = (res["ok"] and res["launched"] == nsub
              and res["launched_main"] == 0)
        say(f"[kernel vs plain] combustion step_fused_halo {variant} "
            f"{str(dtype)[6:]} {nsub} sub-steps: max abs err "
            f"{res['max_abs_err']:.3e} (rtol {res['tol']['rtol']}, atol "
            f"{res['tol']['atol']}) {'ok' if ok else 'FAIL'}")
        check(ok, f"combustion step_fused_halo {variant} disagrees with its "
              f"plain version: {res}")
    for name in sorted(mc.CASES):
        res = mc.check(name, device=dev)
        say(f"[multichip_check] {mc.summary(res)}")
        check(res["ok"], mc.summary(res))
    # the narrow combustion case: cuts within the exchange width of both
    # wall rows and through the obstacles; the halo entries on every
    # shard's slab against their plain version
    case, _ = mc.make_case("combustion_narrow", dev)
    state, static = mc._shards(case)
    ext = case.step.exchange(*state, *static)
    res = mc.against_plain(case, ext, case.step.compute(*ext))
    say(f"[kernel vs plain] combustion_narrow: the halo entries on every "
        f"shard's slab, float32 1 sub-step: max abs err {res['plain_err']:.3e}"
        f" (rtol {res['plain_tol']['rtol']}, atol {res['plain_tol']['atol']}) "
        f"{'ok' if res['plain_ok'] else 'FAIL'}")
    check(res["plain_ok"], f"combustion_narrow: the halo entries disagree "
          f"with their plain version: {res}")
    del case, state, ext
    # the decomposition's main path: every path at full width, the shards
    # of each on this card one after another; at the 1D paths the halo
    # entries are also held against their plain version on the same
    # extended slabs
    for mod in mc.HALO_ENTRIES.values():
        _zero(mod, halo=True)          # count the decomposition's steps only
    halo_case = {"sc": "sc", "hcz": "hcz_wide", "fakhari": "fakhari",
                 "scrt": "scrt", "hcz3d": "hcz3d", "combustion": "combustion"}
    full = {}
    for name in ("hcz_wide", "hcz2d", "sc", "sc2d", "fakhari", "scrt", "hcz3d",
                 "combustion"):
        res = mc.check(name, device=dev, full=True, timing=True,
                       plain=name in halo_case.values())
        full[name] = res
        cells = res["cells"]
        say(f"[decomposition] {mc.summary(res)}")
        say(f"[decomposition] {name}: {res['step_ms']:.5f} ms per step "
            f"({cells / res['step_ms'] / 1e3:.1f} MLUPS) against the "
            f"single-lattice kernel's {res['single_ms']:.5f} ms "
            f"({cells / res['single_ms'] / 1e3:.1f} MLUPS); exchange "
            f"{res['exchange_ms']:.5f} ms per step "
            f"({100 * res['exchange_share']:.1f}% of the step), halo entries "
            f"and crops {res['compute_ms']:.5f} ms; extended slabs "
            f"{res['ext_cells']} cells, {res['bound_cells']:.0f} needed a "
            f"sub-step on average, against {cells}; on {card}")
        check(res["ok"], mc.summary(res))
        if "plain_err" in res:
            tol = res["plain_tol"]
            say(f"[kernel vs plain] {name}: the halo entries on every "
                f"shard's extended slab, float32 {res['nsub']} sub-steps: max "
                f"abs err {res['plain_err']:.3e} (rtol {tol['rtol']}, atol "
                f"{tol['atol']}) {'ok' if res['plain_ok'] else 'FAIL'}")
            check(res["plain_ok"], f"{name}: the halo entries disagree with "
                  f"their plain version at full width: {res['plain_err']}")
    halo_launches = {f: _steps(mod, halo=True)
                     for f, mod in mc.HALO_ENTRIES.items()}
    check(all(v > 0 for v in halo_launches.values()),
          f"a decomposed path did not launch its halo kernel: {halo_launches}")
    say(f"[decomposition] phase 14 {time.perf_counter() - t14:.1f} s; halo "
        f"launches {halo_launches}")

    # ---- 12. pulsatile main path ----
    recs_pl = {}
    for size in (384, 64):
        rec_p, rd, _ = bench.run(model="pulsatile", size=size, steps=2,
                                 steps2=6, plain=True)
        say(f"[bench pulsatile {size} plain] {json.dumps(rec_p)}")
        check(rd.valid, rec_p)
        recs_pl[size] = [rec_p]
        del rd
    for name, regs, stores, loads in ptxas_report(
            _build.build_log, "pulsatile_step", PB_KERNELS):
        say(f"[build] {name}: {regs} registers, spill stores {stores} B, "
            f"spill loads {loads} B")
    _zero(pulsatile_fused)       # count the pulsatile path's steps only
    pb_per_step = {}
    for size, a, b, prof_steps in ((384, 100, 300, 50), (64, 500, 1500, 200)):
        rec_k, rd, st0 = bench.run(model="pulsatile", size=size, steps=a,
                                   steps2=b, profile_steps=prof_steps)
        say(f"[bench pulsatile {size} kernel] {json.dumps(rec_k)}")
        prof = rec_k["profile"]
        say(f"[profile] pulsatile {size}: " + ", ".join(
            f"{kernel_name(k['name'])} {k['ms_per_step']:.5f} ms "
            f"({k['calls_per_step']:g} a step)" for k in prof["kernels"])
            + f"; busy {prof['device_busy_ms_per_step']:.5f} ms a step, idle "
            f"{100 * prof['idle_share']:.1f}%")
        pb_per_step[size] = sum(
            k["calls_per_step"] for k in prof["kernels"]
            if any(f"{n}<" in k["name"] for n in PB_KERNELS))
        check(pb_per_step[size] == pulsatile_fused.LAUNCHES_PER_STEP,
              f"pulsatile_step launched {pb_per_step[size]} kernels a step at "
              f"N={size}, not {pulsatile_fused.LAUNCHES_PER_STEP}")
        check(rd.valid, rec_k)
        check(all(bool(torch.isfinite(t).all()) for t in rd.out
                  if t.is_floating_point()), "non-finite pulsatile state")
        recs_pl[size].insert(0, rec_k)
        say(f"[main path] kernel {rec_k['value']:.1f} MLUPS "
            f"({rec_k['ms_per_step']:.4f} ms per step) vs plain "
            f"{recs_pl[size][1]['value']:.3f} MLUPS "
            f"({recs_pl[size][1]['ms_per_step']:.2f} ms per step) at the "
            f"pulsatile vessel N={size}, fluid share {rec_k['fluid_share']:.3f},"
            f" on {card}")
        del rd, st0
    check(recs_pl[384][0]["fluid_share"] > 0.5,
          f"the N=384 vessel is not open: {recs_pl[384][0]['fluid_share']}")
    check(_steps(pulsatile_fused) > 0, "the pulsatile bench did not launch "
          "the kernel")
    # The plain runs behind the gates are bound by the host (hundreds of
    # small launches a step): after the last timed phase they run in worker
    # processes, beside the CLI and the kernel's full runs here.
    t_pool = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        fut_ref = pool.submit(timed, "pulsatile_fullrun", "reference_metrics",
                              device="cuda")
        fut_mod = pool.submit(timed, "womersley", "run_module_validation",
                              device="cuda", verbose=False)
        fut_core = pool.submit(timed, "womersley", "run_validation",
                               device="cuda", verbose=False)
        before_cli = _steps(pulsatile_fused)
        t0 = time.perf_counter()
        produced = run_cli(coolbm, ["PulsatileBloodFlow2D", "--f32", "--steps",
                                    "300"],
                           ("sol_0000000.vtk", "sol_0000150.vtk",
                            "sol_0000300.vtk"))
        check(sum(n.startswith("sol_") for n in produced) == 101,
              "PulsatileBloodFlow2D --steps 300 did not write 101 dumps")
        check(_steps(pulsatile_fused) > before_cli,
              "the PulsatileBloodFlow2D CLI did not launch the kernel")
        say(f"[cli] PulsatileBloodFlow2D {time.perf_counter() - t0:.1f} s")
        # the main path ends here; the gate's runs hold the kernel to the
        # plain path and are not counted
        pulsatile_launches = _steps(pulsatile_fused)
        t0 = time.perf_counter()
        sims32, diag = pulsatile_fullrun.kernel_runs("f32", device=dev)
        sims64, _ = pulsatile_fullrun.kernel_runs("f64", device=dev)
        secs = time.perf_counter() - t0
        reference, secs_ref = fut_ref.result()
        ok, _ = pulsatile_fullrun.run_gate(sims32, diag, reference)
        say(f"[full run] N=64 2765 steps: kernel {len(sims32)} float32 and "
            f"{len(sims64)} float64 runs {secs:.1f} s, plain float64 "
            f"{secs_ref:.1f} s (worker); order-dependent steps "
            f"{diag['order_dep_steps']}, reseeded cells "
            f"{diag['reseed_cells']} ({'PASS' if ok else 'FAIL'})")
        check(ok, "the pulsatile full run departs from the float64 plain run")
        premise, _ = pulsatile_fullrun.self_check(sims64, reference)
        say(f"[full run] self-check: the gated metrics of "
            f"{len(sims64) - 1} float64 runs perturbed by an ulp within half "
            f"their gates ({'PASS' if premise else 'FAIL'})")
        check(premise, "a gated full-run metric is chaotic")
        errs, secs_mod = fut_mod.result()
        (err_s, err_o), secs_core = fut_core.result()
    say(f"[physics] quirk-free module channel 61x24 ({secs_mod:.1f} s, "
        "worker): " + ", ".join(
            f"{k} {v:.4f} (< {womersley.MODULE_GATES[k]})"
            for k, v in errs.items())
        + f"; core channel ({secs_core:.1f} s, worker): steady {err_s:.5f} "
        f"(< {womersley.GATE_STEADY}), oscillatory {err_o:.5f} "
        f"(< {womersley.GATE_OSC}); gates and CLI together "
        f"{time.perf_counter() - t_pool:.1f} s")
    check(all(errs[k] < womersley.MODULE_GATES[k] for k in errs),
          f"the module channel misses its gates: {errs}")
    check(err_s < womersley.GATE_STEADY and err_o < womersley.GATE_OSC,
          f"the core channel misses its gates: {err_s}, {err_o}")

    def entry(name, source, replaces, launches, err, rec_k, rec_p, work,
              flop_rate=F32_FLOP_PER_S):
        bound_ms, bound_by = bound(work, flop_rate)
        return {"name": name, "route": "cuda",
                "source": f"multiphase_lbm_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": rec_k["ms_per_step"],
                "plain_ms": rec_p["ms_per_step"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    kernels = [
        entry("sc_step", "sc_step.cu", "multiphase_lbm_tpu/ops/pallas_sc.py:55",
              sc_launches, err_sc, rec, rec_plain, per_cell(sc_fused, n * n)),
        # float64: 144 B of populations and the 4 B mask a cell
        entry("sc_step (const_g layered channel)", "sc_step.cu",
              "multiphase_lbm_tpu/ops/pallas_sc.py:55", layered_launches,
              err_layers, {"ms_per_step": rd_l.ms_per_step},
              {"ms_per_step": rd_lp.ms_per_step},
              (64 * 64 * 148, 64 * 64 * sc_fused.WORK_PER_CELL[1]),
              F64_FLOP_PER_S),
        entry("hcz_step", "hcz_step.cu",
              "multiphase_lbm_tpu/ops/pallas_hcz.py:42", hcz_launches, err_hcz,
              rec_rti, rec_rti_plain, per_cell(hcz_fused, 2048 * 8194)),
        entry("hcz3d_step", "hcz3d_step.cu",
              "multiphase_lbm_tpu/ops/pallas_hcz3d.py:39",
              hcz3d_launches, err_hcz3d, rec_3d, rec_3d_plain,
              per_cell(hcz3d_fused, 128 ** 3))
        | {"launches_per_step": hcz3d_per_step},
        entry("fakhari_step", "fakhari_step.cu",
              "multiphase_lbm_tpu/ops/pallas_fakhari.py:124", fakhari_launches,
              err_fakhari, rec_fk, rec_fk_plain, per_cell(fakhari_fused, n * n)),
        entry("scrt_step", "scrt_step.cu",
              "multiphase_lbm_tpu/ops/pallas_scrt.py:61", scrt_launches,
              err_scrt, rec_rt, rec_rt_plain,
              per_cell(scrt_fused, n * (4 * n + 2))),
        entry("pulsatile_step", "pulsatile_step.cu",
              "multiphase_lbm_tpu/ops/pallas_pulsatile_full.py:87",
              pulsatile_launches, err_pulsatile, *recs_pl[384],
              per_cell(pulsatile_fused, pbig.nx * pbig.ny))
        | {"launches_per_step": pb_per_step[384]},
        entry("combustion_step", "combustion_step.cu",
              "multiphase_lbm_tpu/ops/pallas_combustion.py:171",
              combustion_launches, err_cb, *recs_cb[(420, False)],
              combustion_fused.step_work(bench.combustion_params(420))),
    ]
    # the halo-in routes: the kernel on each shard's extended slab at the
    # full-width decomposition of its family, held against its plain
    # version there; bound by the work of the cells each sub-step must keep
    # valid (multichip_check.halo_bound_work)
    for family, base, line in (("sc", "sc_step", "pallas_sc.py:326"),
                               ("hcz", "hcz_step", "pallas_hcz.py:318"),
                               ("fakhari", "fakhari_step", "pallas_fakhari.py:354"),
                               ("scrt", "scrt_step", "pallas_scrt.py:277"),
                               ("hcz3d", "hcz3d_step", "pallas_hcz3d.py:299"),
                               ("combustion", "combustion_step",
                                "pallas_combustion.py:845")):
        res = full[halo_case[family]]
        fn = "step_fused_halo_3d" if family == "hcz3d" else "step_fused_halo"
        kernels.append(entry(
            f"{base} ({fn})", f"{base}.cu", f"multiphase_lbm_tpu/ops/{line}",
            halo_launches[family], res["plain_err"],
            {"ms_per_step": res["compute_ms"]}, {"ms_per_step": res["plain_ms"]},
            res["bound_work"]))
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
