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
  N = 128, ω = 1), float32, kernel ``csrc/scrt_step.cu``;
* ``pulsatile``: the severed deformable vessel of the reference's
  PulsatileBloodFlow2D at nx = 1 + 10 (N − 2), ny = N, in the reference
  parity mode, float32, kernel ``csrc/pulsatile_step.cu``, with one
  departure from the reference: the wall compliance is scaled to the size,
  α = 0.01 · 64/N (:func:`pulsatile_params`).  ``--size 384`` (the
  default, 3,821 × 384, 1.47 M cells, 124 MB of state, 2.5 times the L2)
  is the largest size seen to stay finite through the warm-up.  N = 512
  stayed finite through 4N steps while the plain path and the kernel took
  the JAX model's dense MRT, and goes non-finite in the opening transient
  (by step 416) since both take the Pallas kernel's low-rank form, which
  rounds differently: the transient is at the edge of stability there.
  N = 768 and 1024 go non-finite by step 192 in either form.  ``--size
  64`` is the reference's own case (621 × 64), whose state fits in L2, so
  launches set its pace.  The vessel starts closed at the inlet and its
  walls open by at most 0.25 rows a step, so the state is first warmed
  through the kernel for 4N steps (:func:`pulsatile_warm_state`, which
  names the step where a size goes non-finite) and the slope times the
  open vessel; the JSON line carries the warm-up's steps, α and the warmed
  state's fluid share;
* ``combustion``: the reactive MRT channel of the reference's Xu-2018 case
  (``CooLBM_MRT_combustion.cpp:55-56`` and the ``CombustionParams``
  defaults: four reactive obstacles, LI2014 conjugate heat), nx = N,
  ny = 4N/21, float32, kernel ``csrc/combustion_step.cu``.  ``--size 420``
  (the default, 420 × 80) is the reference's own lattice and ``--size 840``
  (840 × 160) the JAX package's large combustion workload
  (``runners/bench_suite.py:227-242``); both states (288 B of float32 state
  per cell: 9.7 and 38.7 MB) fit in the card's 50 MB L2.  One departure
  from the reference's cold start: the state starts from
  ``initialize(T_solid=1.8)`` with ``Y_O2_ini = 0.22``, so the Arrhenius
  reaction, the anti-bounce-back with Y_int and the heat release are live
  from the first step (from the cold start the inlet O₂ does not reach the
  first obstacle, at x = 100, for thousands of steps).  One ``first_step``
  step and a warm-up of 2N steps in all through the kernel precede the
  timed window (the inlet's pressure wave, at the speed of sound, reaches
  the outlet by then, so both audit fluxes are positive), which runs all
  four populations, or the flow alone with ``--flow-only``.

    python -m multiphase_lbm_tpu_torch.bench [--model sc|rti|hcz3d|fakhari|scrt|pulsatile|combustion]
        [--size N] [--steps 200] [--steps2 600] [--collision mrt] [--plain]
        [--flow-only] [--reps 3] [--profile STEPS]

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
from typing import Callable, NamedTuple, Optional

import torch

from .io.config import lb_parameters
from .models import combustion as cbm
from .models import fakhari as fk
from .models import hcz
from .models import pulsatile as pm
from .models import shan_chen as sc
from .models import shan_chen_rt as rt
from .ops import (combustion_fused, fakhari_fused, hcz3d_fused, hcz_fused,
                  pulsatile_fused, sc_fused, scrt_fused)
from .utils.profiling import device_profile, measure_mlups_slope
from .validation.rti_regression import rti_state

DEFAULT_SIZE = {"sc": 2048, "rti": 2048, "hcz3d": 128, "fakhari": 2048,
                "scrt": 2048, "pulsatile": 384, "combustion": 420}


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


def pulsatile_params(n):
    """The reference vessel at ny = n: nx = 1 + 10 (n − 2), and the wall
    compliance α = 0.01 · 64/n, a departure from the reference, which takes
    α = 0.01 at every size.  The closed vessel's initial pressure is
    (yr2 − (n − 1.5))·α + 0.02 ≈ (1 + R − n/2)·α + 0.02, R ≤ 2 the
    vessel's radius: −0.29 to −0.27 at the reference's n = 64, but about
    −1.2 at n = 256 and −5.1 at n = 1024 with α = 0.01; the scaled α keeps
    it near the reference's −0.3 at every size."""
    return pm.PulsatileParams(nx=1 + 10 * (n - 2), ny=n,
                              alpha=0.01 * 64 / n)


def pulsatile_warm_state(n, device):
    """``(params, state, t)``: the vessel after 4n steps through the kernel
    (its walls open by at most 0.25 rows a step, so the severed inlet needs
    2n steps at least to open), float32.  Raises, naming the first block of
    n/16 steps that ended non-finite, if the vessel does not stay finite."""
    p = pulsatile_params(n)
    st = pm.initialize(p, torch.float32, device=device)
    block = max(1, n // 16)
    for t in range(0, 4 * n, block):
        st, _ = pulsatile_fused.run_fused_full(st, t, p, block)
        if not bool(torch.isfinite(st.P).all()):
            raise RuntimeError(f"the N={n} vessel went non-finite by step "
                               f"{t + block} of its {4 * n}-step warm-up")
    return p, st, 4 * n


def combustion_params(n):
    """The reference's combustion channel at nx = n, ny = 4n/21 (420 × 80
    at n = 420), with ``Y_O2_ini = 0.22``, so that the reaction is live from
    the first step (see the module docstring)."""
    return cbm.CombustionParams(nx=n, ny=(4 * n) // 21, Y_O2_ini=0.22)


def combustion_warmup_steps(p):
    """Steps through the kernel before a combustion timing: 2 nx, so the
    inlet's pressure wave, at the speed of sound, has reached the outlet
    and both audit fluxes are positive."""
    return 2 * p.nx


def combustion_state(p, device):
    """``initialize(T_solid=1.8)`` of ``p`` in float32 after one
    ``first_step`` step and the rest of :func:`combustion_warmup_steps`, all
    four populations, through the kernel on a card (the plain path on the
    CPU)."""
    flags, _ = cbm.build_geometry(p)
    st = cbm.initialize(p, torch.float32, T_solid=1.8, flags=flags,
                        device=device)
    return combustion_fused.run_fused(st, p, combustion_warmup_steps(p),
                                      first_step=True)


class _Case(NamedTuple):
    """One benchmark: its initial state, ``make_step(n)`` (a callable that
    runs n steps), its cell count, its metric name, extra keys for its JSON
    line, and the check of the state after the run where not every tensor
    is finite by design (else every tensor must be finite)."""
    state0: object
    make_step: Callable
    nelem: int
    metric: str
    extra: dict
    finite: Optional[Callable] = None


def _case(model, n, collision, plain, device, flow_only=False) -> _Case:
    """The :class:`_Case` of one benchmark."""
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
        return _Case(f0, make_step, n * n,
                     f"MLUPS_D2Q9_{collision.upper()}_ShanChen_{n}x{n}_{label}",
                     {})
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
        return _Case(state0, make_step, n * ny,
                     f"MLUPS_D2Q9_HCZ_RTI_{n}x{ny}_{label}", {})
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
        return _Case(state0, make_step, n ** 3,
                     f"MLUPS_D3Q19_HCZ_droplet_{n}^3_{label}", {})
    if model == "fakhari":
        p = fk.FakhariParams()
        state0 = fk.init_bubble(n, n, p, dtype=torch.float32, device=device)
        if plain:
            def make_step(ns):
                return lambda s: fk.run(s, p, ns)
        else:
            def make_step(ns):
                return lambda s: fakhari_fused.run_fused(*s, p, ns)
        return _Case(state0, make_step, n * n,
                     f"MLUPS_D2Q9_Fakhari_bubble_{n}x{n}_{label}", {})
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
        return _Case(f0, make_step, n * ny,
                     f"MLUPS_D2Q9_SCRT_{n}x{ny}_{label}", {})
    if model == "pulsatile":
        p, state0, t0 = pulsatile_warm_state(n, device)
        if plain:
            def make_step(ns):
                return lambda s: pm.run(s, t0, p, ns)
        else:
            def make_step(ns):
                return lambda s: pulsatile_fused.run_fused_full(s, t0, p,
                                                                ns)[0]
        return _Case(state0, make_step, p.nx * p.ny,
                     f"MLUPS_D2Q9_MRT_pulsatile_{p.nx}x{p.ny}_{label}",
                     {"warmup_steps": t0, "alpha": p.alpha,
                      "fluid_share": float(state0.fluid.float().mean())})
    if model == "combustion":
        p = combustion_params(n)
        state0 = combustion_state(p, device)
        konv = not flow_only
        if plain:
            def make_step(ns):
                return lambda s: cbm.run(s, p, ns, konv=konv)
        else:
            def make_step(ns):
                return lambda s: combustion_fused.run_fused(s, p, ns,
                                                            konv=konv)
        part = "konv" if konv else "flow_only"
        flags, _ = cbm.build_geometry(p)
        return _Case(state0, make_step, p.nx * p.ny,
                     f"MLUPS_D2Q9_MRT_combustion_{p.nx}x{p.ny}_{part}_{label}",
                     {"konv": konv, "warmup_steps": combustion_warmup_steps(p)},
                     lambda st: all(bool(torch.isfinite(v).all()) for v in
                                    cbm.defined_values(st, flags).values()))
    raise ValueError(f"unknown model {model!r}")


def run(size=None, steps=200, steps2=None, collision="mrt", plain=False,
        reps=3, model="sc", profile_steps=0, flow_only=False):
    """Time one benchmark on ``cuda``; returns ``(record, reading, state0)``
    where ``reading.out`` is the state after the last timed call and
    ``state0`` the initial state it started from (a tensor for ``sc`` and
    ``scrt``, an ``(f, g)`` pair for the HCZ models, ``(h, g, u)`` for
    ``fakhari``, a ``PulsatileState`` for ``pulsatile``, a
    ``CombustionState`` for ``combustion``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    n = size or DEFAULT_SIZE[model]
    state0, make_step, nelem, metric, extra, finite = _case(
        model, n, collision, plain, torch.device("cuda"), flow_only)
    steps2 = 3 * steps if steps2 is None else steps2
    reading = measure_mlups_slope(make_step, state0, steps, steps2, nelem,
                                  reps=reps)
    out = reading.out if isinstance(reading.out, tuple) else (reading.out,)
    if not (finite(reading.out) if finite else
            all(bool(torch.isfinite(t).all()) for t in out)):
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
    rec.update(extra)
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
                    help="lattice N (default 2048, 128 for hcz3d, 384 "
                         "for pulsatile, 420 for combustion); rti and scrt "
                         "run N x (4N + 2), pulsatile (1 + 10 (N - 2)) x N, "
                         "combustion N x 4N/21")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--steps2", type=int, default=None,
                    help="second step count of the slope (default 3x --steps)")
    ap.add_argument("--collision", default="mrt", choices=["bgk", "mrt"],
                    help="collision of the sc model")
    ap.add_argument("--plain", action="store_true",
                    help="time the plain PyTorch path instead of the kernel")
    ap.add_argument("--flow-only", action="store_true",
                    help="combustion: time the flow population alone "
                         "(konv off)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="also profile one call of STEPS steps (device "
                         "time by kernel, idle share)")
    args = ap.parse_args(argv)
    rec, reading, _ = run(args.size, args.steps, args.steps2, args.collision,
                          args.plain, args.reps, model=args.model,
                          profile_steps=args.profile,
                          flow_only=args.flow_only)
    print(json.dumps(rec))
    return 0 if reading.valid else 1


if __name__ == "__main__":
    sys.exit(main())
