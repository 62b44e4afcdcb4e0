"""Headline benchmark on the GPU: D2Q9 MRT + Shan–Chen, 2048² periodic
droplet (R = n/8), float32, through the fused CUDA kernel.

    python -m multiphase_lbm_tpu_torch.bench [--size 2048] [--steps 200]
        [--steps2 600] [--collision mrt] [--plain] [--reps 3]

Prints ONE JSON line: ``metric`` (names the CUDA path, or the plain
PyTorch path with ``--plain``), ``value`` in MLUPS (the reference's
definition, nelem · steps / µs), the slope protocol's ``spread`` and
``overhead_ms``, and the card's name and power limit as ``nvidia-smi``
reports them.  Needs a CUDA device and fails without one; a slope
reading that comes out invalid (per-step time ≤ 0) is reported as an
error with no value.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from .models import shan_chen as sc
from .ops import sc_fused
from .utils.profiling import measure_mlups_slope


def card_name_and_power() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` gives it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def run(size=2048, steps=200, steps2=None, collision="mrt", plain=False,
        reps=3):
    """Time the headline on ``cuda``; returns ``(record, reading, f0)``
    where ``reading.out`` is the state after the last timed call and
    ``f0`` the initial state it started from."""
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    device = torch.device("cuda")
    n = size
    p = sc.SCParams(collision=collision)
    f0 = sc.init_droplet(n, n, p, radius=n / 8.0, dtype=torch.float32,
                         device=device)
    fluid = sc.geometry_periodic(n, n, device=device)
    fluid_f32 = fluid.to(torch.float32)

    if plain:
        def make_step(ns):
            return lambda v: sc.run(v, fluid, p, ns)
        label = "plain_PyTorch"
    else:
        def make_step(ns):
            return lambda v: sc_fused.run_fused(v, fluid_f32, p, ns,
                                                periodic=True)
        label = "CUDA"

    steps2 = 3 * steps if steps2 is None else steps2
    reading = measure_mlups_slope(make_step, f0, steps, steps2, n * n,
                                  reps=reps)
    if not bool(torch.isfinite(reading.out).all()):
        raise RuntimeError("non-finite state after benchmark")
    rec = {
        "metric": f"MLUPS_D2Q9_{collision.upper()}_ShanChen_{n}x{n}_{label}",
        "value": reading.mlups,
        "unit": "MLUPS",
        "ms_per_step": reading.ms_per_step,
        "spread": reading.spread,
        "overhead_ms": reading.overhead_ms,
        "protocol": f"slope {steps}/{steps2} steps, median of {reps}",
        "device": torch.cuda.get_device_name(0),
        "card": card_name_and_power(),
    }
    if not reading.valid:
        rec["error"] = "invalid slope reading (per-step time <= 0)"
    return rec, reading, f0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench")
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--steps2", type=int, default=None,
                    help="second step count of the slope (default 3x --steps)")
    ap.add_argument("--collision", default="mrt", choices=["bgk", "mrt"])
    ap.add_argument("--plain", action="store_true",
                    help="time the plain PyTorch path instead of the kernel")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    rec, reading, _ = run(args.size, args.steps, args.steps2, args.collision,
                          args.plain, args.reps)
    print(json.dumps(rec))
    return 0 if reading.valid else 1


if __name__ == "__main__":
    sys.exit(main())
