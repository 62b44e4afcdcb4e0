"""Benchmarks on the GPU, one per model family, through the fused CUDA
kernels:

* ``sc`` (default, the headline): D2Q9 MRT + Shan–Chen, 2048² periodic
  droplet (R = n/8), float32, kernel ``csrc/sc_step.cu``;
* ``rti``: RTI-2048, the HCZ phase-field Rayleigh–Taylor run of the
  reference's high-resolution validation, 2048 × 8194 (4N + 2 rows, walls
  at y = 0 and y = ny − 1, no padding), float32, kernel
  ``csrc/hcz_step.cu``; the physical parameters of the literature
  regression (:func:`.validation.rti_regression.rti_params`) at N = 2048:
  Re 2048, u_lb 0.04, κ 0.01, gravity −u_lb²/N;
* ``hcz3d``: the D3Q19 HCZ droplet (``configs/pf_laplace3D.txt`` physics,
  ω = 1 from Re 6, u_lb 0.01 at N = 100), 128³ periodic, float32, kernel
  ``csrc/hcz3d_step.cu``;
* ``fakhari``: the Fakhari conservative phase-field bubble
  (``configs/young_laplace2D.txt`` physics, the ``FakhariParams`` defaults:
  ρ_H/ρ_L = 1000, τ = 0.8), 2048² periodic, R = N/8, float32, kernel
  ``csrc/fakhari_step.cu``;
* ``scrt``: the Shan–Chen Rayleigh–Taylor channel at the reference's
  {N, 4N + 2} domain, 2048 × 8194 (walls at y = 0 and y = ny − 1), with the
  ``SCRTParams`` defaults (``configs/sc_RayleighTaylor2D.txt`` physics at
  N = 128, ω = 1), float32, kernel ``csrc/scrt_step.cu``.

    python -m multiphase_lbm_tpu_torch.bench [--model sc|rti|hcz3d|fakhari|scrt]
        [--size N] [--steps 200] [--steps2 600] [--collision mrt] [--plain]
        [--reps 3] [--profile STEPS]

Prints ONE JSON line: ``metric`` (names the model, the lattice and the CUDA
path, or the plain PyTorch path with ``--plain``), ``value`` in MLUPS (the
reference's definition, nelem · steps / µs), the slope protocol's
``spread`` and ``overhead_ms``, and the card's name and power limit as
``nvidia-smi`` reports them; with ``--profile``, also the device time
per step of each kernel, the device's busy time and its idle share over
one more call of that many steps under ``torch.profiler``.  Needs a CUDA
device and fails without one; a
slope reading that comes out invalid (per-step time ≤ 0) is reported as an
error with no value.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from .io.config import lb_parameters
from .models import fakhari as fk
from .models import hcz
from .models import shan_chen as sc
from .models import shan_chen_rt as rt
from .ops import fakhari_fused, hcz3d_fused, hcz_fused, sc_fused, scrt_fused
from .utils.profiling import device_profile, measure_mlups_slope
from .validation.rti_regression import rti_state

DEFAULT_SIZE = {"sc": 2048, "rti": 2048, "hcz3d": 128, "fakhari": 2048,
                "scrt": 2048}


def card_name_and_power() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` gives it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def hcz3d_params() -> hcz.HCZParams:
    """``configs/pf_laplace3D.txt`` physics (Re 6, u_lb 0.01 at N = 100
    give ω = 1; κ 5e-4)."""
    _, omega, _, _ = lb_parameters(0.01, 100, 6.0)
    return hcz.HCZParams(omega=omega, kappa=5e-4)


def _case(model, n, collision, plain, device):
    """``(state0, make_step, nelem, metric)`` of one benchmark."""
    label = "plain_PyTorch" if plain else "CUDA"
    if model == "sc":
        p = sc.SCParams(collision=collision)
        f0 = sc.init_droplet(n, n, p, radius=n / 8.0, dtype=torch.float32,
                             device=device)
        fluid = sc.geometry_periodic(n, n, device=device)
        fluid_f32 = fluid.to(torch.float32)
        if plain:
            def make_step(ns):
                return lambda v: sc.run(v, fluid, p, ns)
        else:
            def make_step(ns):
                return lambda v: sc_fused.run_fused(v, fluid_f32, p, ns,
                                                    periodic=True)
        return (f0, make_step, n * n,
                f"MLUPS_D2Q9_{collision.upper()}_ShanChen_{n}x{n}_{label}")
    if model == "rti":
        p, state0, fluid = rti_state(n, device)
        fluid_f32 = fluid.to(torch.float32)
        if plain:
            def make_step(ns):
                return lambda s: hcz.run(s, fluid, p, ns)
        else:
            def make_step(ns):
                return lambda s: hcz_fused.run_fused(*s, fluid_f32, p, ns)
        ny = 4 * n + 2
        return state0, make_step, n * ny, f"MLUPS_D2Q9_HCZ_RTI_{n}x{ny}_{label}"
    if model == "hcz3d":
        p = hcz3d_params()
        state0 = hcz.init_droplet_3d(n, n, n, p, dtype=torch.float32,
                                     device=device)
        fluid = hcz.geometry_periodic_3d(n, n, n, device=device)
        if plain:
            def make_step(ns):
                return lambda s: hcz.run(s, fluid, p, ns, lattice=hcz.D3Q19,
                                         three_d=True)
        else:
            def make_step(ns):
                return lambda s: hcz3d_fused.run_fused_3d(*s, p, ns)
        return (state0, make_step, n ** 3,
                f"MLUPS_D3Q19_HCZ_droplet_{n}^3_{label}")
    if model == "fakhari":
        p = fk.FakhariParams()
        state0 = fk.init_bubble(n, n, p, dtype=torch.float32, device=device)
        if plain:
            def make_step(ns):
                return lambda s: fk.run(s, p, ns)
        else:
            def make_step(ns):
                return lambda s: fakhari_fused.run_fused(*s, p, ns)
        return (state0, make_step, n * n,
                f"MLUPS_D2Q9_Fakhari_bubble_{n}x{n}_{label}")
    if model == "scrt":
        p = rt.SCRTParams()
        ny = 4 * n + 2
        fluid = rt.geometry_channel(n, ny, device=device)
        f0 = rt.init_interface(n, ny, p, dtype=torch.float32,
                               device=device) * fluid[None]
        if plain:
            def make_step(ns):
                return lambda v: rt.run(v, fluid, p, ns)
        else:
            def make_step(ns):
                return lambda v: scrt_fused.run_fused(v, p, ns)
        return f0, make_step, n * ny, f"MLUPS_D2Q9_SCRT_{n}x{ny}_{label}"
    raise ValueError(f"unknown model {model!r}")


def run(size=None, steps=200, steps2=None, collision="mrt", plain=False,
        reps=3, model="sc", profile_steps=0):
    """Time one benchmark on ``cuda``; returns ``(record, reading, state0)``
    where ``reading.out`` is the state after the last timed call and
    ``state0`` the initial state it started from (a tensor for ``sc`` and
    ``scrt``, an ``(f, g)`` pair for the HCZ models, ``(h, g, u)`` for
    ``fakhari``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    n = size or DEFAULT_SIZE[model]
    state0, make_step, nelem, metric = _case(model, n, collision, plain,
                                             torch.device("cuda"))
    steps2 = 3 * steps if steps2 is None else steps2
    reading = measure_mlups_slope(make_step, state0, steps, steps2, nelem,
                                  reps=reps)
    out = reading.out if isinstance(reading.out, tuple) else (reading.out,)
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise RuntimeError("non-finite state after benchmark")
    rec = {
        "metric": metric,
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
    if profile_steps:
        rec["profile"] = device_profile(make_step(profile_steps), state0,
                                        profile_steps)
    return rec, reading, state0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench")
    ap.add_argument("--model", default="sc", choices=sorted(DEFAULT_SIZE))
    ap.add_argument("--size", type=int, default=None,
                    help="lattice N (default 2048, 128 for hcz3d); rti "
                         "and scrt run N x (4N + 2)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--steps2", type=int, default=None,
                    help="second step count of the slope (default 3x --steps)")
    ap.add_argument("--collision", default="mrt", choices=["bgk", "mrt"],
                    help="collision of the sc model")
    ap.add_argument("--plain", action="store_true",
                    help="time the plain PyTorch path instead of the kernel")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="also profile one call of STEPS steps (device "
                         "time by kernel, idle share)")
    args = ap.parse_args(argv)
    rec, reading, _ = run(args.size, args.steps, args.steps2, args.collision,
                          args.plain, args.reps, model=args.model,
                          profile_steps=args.profile)
    print(json.dumps(rec))
    return 0 if reading.valid else 1


if __name__ == "__main__":
    sys.exit(main())
