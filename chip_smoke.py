#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernel,
holds it against the plain PyTorch path, drives the main path (the 2048²
SC-MRT float32 headline and the laplace2D_sc CLI) and checks the physics.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device   — a CUDA device is required; prints the card's name and power
                limit as nvidia-smi reports them.
  2. build    — nvcc builds csrc/*.cu; prints the seconds and ptxas report.
  3. kernel vs plain on the card, ω = 1.25 (τ = 0.8) so the rank-2 MRT term
     is live: {periodic 256², walled 256×128 with ρ_w = 0.2 and the droplet
     on the wall} × {BGK, MRT}, float32 over 5 steps (rtol 2e-5, atol 2e-6:
     sum order and FMA contraction differ from the plain path) and float64
     over 20 steps (atol 1e-12); and 2048² periodic MRT float32, 5 steps.
  4. main path — multiphase_lbm_tpu_torch.bench at 2048², MRT, float32,
     periodic, through the kernel (slope protocol), beside the plain path
     at the same size; state finite, mass drift < 1e-4 (summed in float64),
     droplet ρ ≈ 0.265 inside and ≈ 0.038 far away (±10%).
  5. CLI      — coolbm laplace2D_sc --f32 --steps 800 with the repo config
     writes sol_0000000.vtk, sol_0000400.vtk, mass.dat, energy.dat and its
     MLUPS line, through the kernel.
Then one JSON line per kernel of the path (launches counted over phases
4-5 only) and, last, {"ok": true, "device": {...}}.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

F32_TOL = dict(rtol=2e-5, atol=2e-6)
F64_TOL = dict(rtol=0.0, atol=1e-12)


def say(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_err_within(out, ref, rtol, atol):
    """(max |out − ref|, whether |out − ref| <= atol + rtol·|ref| everywhere)."""
    d = (out.double() - ref.double()).abs()
    ok = bool(torch.isfinite(out).all()) and bool(
        (d <= atol + rtol * ref.double().abs()).all())
    return float(d.max()), ok


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
    from multiphase_lbm_tpu_torch.models import shan_chen as sc
    from multiphase_lbm_tpu_torch.ops import _build, sc_fused
    from multiphase_lbm_tpu_torch.runners import coolbm

    # ---- 2. build ----
    _build.build()
    _build.load()
    say(f"[build] {_build.LIB_PATH.name} in {_build.build_seconds or 0.0:.1f} s"
        f" (0.0 = already current)")
    if _build.build_log:
        say(_build.build_log.strip())

    # ---- 3. kernel against the plain version ----
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
                torch.cuda.synchronize()
                err, ok = max_err_within(out, ref, **tol)
                name = (f"{geometry} {nx}x{ny} {collision} omega=1.25 "
                        f"{str(dtype)[6:]} {steps} steps")
                say(f"[kernel vs plain] {name}: max abs err {err:.3e} "
                    f"(rtol {tol['rtol']}, atol {tol['atol']}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(name)
    n = 2048
    err_2048 = 0.0
    for omega in (1.0, 1.25):
        p = sc.SCParams(collision="mrt", omega=omega)
        f = sc.init_droplet(n, n, p, radius=n / 8.0, dtype=torch.float32,
                            device=dev)
        fluid = sc.geometry_periodic(n, n, device=dev)
        out = sc_fused.run_fused(f, fluid.to(torch.float32), p, 5,
                                 periodic=True)
        ref = sc.run(f, fluid, p, 5)
        torch.cuda.synchronize()
        err, ok = max_err_within(out, ref, **F32_TOL)
        err_2048 = max(err_2048, err)
        name = f"periodic {n}x{n} mrt omega={omega} float32 5 steps"
        say(f"[kernel vs plain] {name}: max abs err {err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
        del f, fluid, out, ref
    if failures:
        raise SystemExit(f"kernel disagrees with the plain path: {failures}")

    # ---- 4. main path: the headline ----
    rec_plain, rd_plain, _ = bench.run(size=n, steps=10, steps2=30, plain=True)
    say(f"[bench plain] {json.dumps(rec_plain)}")
    check(rd_plain.valid, rec_plain)
    del rd_plain
    sc_fused.LAUNCHES = 0              # count the main path's launches only
    rec, rd, f0 = bench.run(size=n, steps=200, steps2=600)
    say(f"[bench kernel] {json.dumps(rec)}")
    check(rd.valid, rec)
    bench_launches = sc_fused.LAUNCHES
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

    # ---- 5. CLI ----
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = coolbm.main(["laplace2D_sc", "--f32", "--steps", "800",
                              "--outdir", tmp, "--device", "cuda"])
        say(buf.getvalue().strip())
        check(rc == 0, f"coolbm returned {rc}")
        produced = sorted(os.listdir(tmp))
        say(f"[cli] wrote {produced}")
        for name in ("sol_0000000.vtk", "sol_0000400.vtk", "mass.dat",
                     "energy.dat"):
            check(name in produced, f"{name} not in {produced}")
        check("MLUPS" in buf.getvalue(), "no MLUPS line")
    check(sc_fused.LAUNCHES > bench_launches, "the CLI did not launch the kernel")

    kernels = [{
        "name": "sc_step",
        "route": "cuda",
        "source": "multiphase_lbm_tpu_torch/csrc/sc_step.cu",
        "replaces": "multiphase_lbm_tpu/ops/pallas_sc.py:55",
        "launches": sc_fused.LAUNCHES,
        "max_abs_err": err_2048,
        "ms": rec["ms_per_step"],
        "plain_ms": rec_plain["ms_per_step"],
    }]
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
