"""Problem-select CLI, the port of ``multiphase_lbm_tpu/runners/coolbm.py``:

    python -m multiphase_lbm_tpu_torch.runners.coolbm <problem> \
        [--config config.txt] [--outdir out] [--steps N] [--f32] \
        [--device cuda|cpu] [--N 64] [--quirk-free] [--scheme li2014]
        [--topology inflow_outflow] [--u-lid U] [--dpdx F] [--restart INI_F]
        [--bench] [--scalar-steps 5000] [--nx 420] [--ny 80]
        [--profile trace.json]

Problems, every one of the JAX CLI: laplace2D_sc, contactAngle2D,
twoLayeredFlow2D_sc, RayleighTaylor2D_sc, Young_Laplace2D, rayleighTaylor2D,
twoLayeredFlow2D, laplace3D, PulsatileBloodFlow2D (no config file; ``--N``
and ``--quirk-free`` as in the JAX CLI) and combustion (no config file; the
combustion flags as in the JAX CLI, ``--steps`` bounds the flow stage).  On
the card, a combustion configuration the kernel does not cover (the
guo2015 and huber2015 schemes) runs the plain path and says so.  The device
defaults to ``cuda``, where the solver runs the fused CUDA kernels (there
is no ``--fused`` flag: on the card the kernel is the path).  The plain
PyTorch path runs only when ``--device cpu`` asks for it: without a visible
card and without that flag the CLI refuses to start, so a missing card is
never hidden behind a CPU run.

``--profile PATH`` runs the problem under ``torch.profiler`` on every
thread and writes its Chrome trace to PATH: the kernels, the program's
``mlbm.*`` spans of the driver and the VTK writer threads on one timeline,
and the counters (``utils/profiling.profile_run``).  It prints the set-up
phases (``utils/profiling.PHASES``: the driver's ``init`` and its
``init.upload`` copies, the card's ``device.context``, the kernel library's
``library.load`` and ``library.build``, each entry's ``kernel.first`` call,
and the ``driver`` call), each with its count and seconds, then the
device's idle share between the loop's first kernel launch and its last
chunk, the idle time by the innermost driver span at each idle gap's
midpoint, and the longest gaps.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

import torch

from ..utils import profiling
from . import apps

PROBLEMS = {
    "laplace2D_sc": (apps.run_sc_laplace2d, "sc_Laplace2D.txt"),
    "contactAngle2D": (apps.run_sc_contact_angle, "sc_contactAngle2D.txt"),
    "twoLayeredFlow2D_sc": (apps.run_sc_two_layered, "sc_twoLayeredFlow2D.txt"),
    "RayleighTaylor2D_sc": (apps.run_rayleigh_taylor_sc,
                            "sc_RayleighTaylor2D.txt"),
    "Young_Laplace2D": (apps.run_young_laplace2d, "young_laplace2D.txt"),
    "rayleighTaylor2D": (apps.run_rayleigh_taylor_pf, "pf_rayleighTaylor2D.txt"),
    "twoLayeredFlow2D": (apps.run_two_layered_pf, "pf_twoLayeredFlow2D.txt"),
    "laplace3D": (apps.run_laplace3d, "pf_laplace3D.txt"),
}

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="coolbm")
    ap.add_argument("problem", choices=list(PROBLEMS)
                    + ["PulsatileBloodFlow2D", "combustion"])
    ap.add_argument("--config", default=None,
                    help="reference-format config_*.txt (defaults to the "
                         "repo's configs/ file for the problem)")
    ap.add_argument("--outdir", default="out")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the step count from the config")
    ap.add_argument("--f32", action="store_true",
                    help="run in float32 (the GPU production dtype)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default, the kernels) or cpu "
                         "(the plain PyTorch path)")
    ap.add_argument("--quirk-free", action="store_true",
                    help="PulsatileBloodFlow2D: the physics mode "
                         "(momentum_quirk=False; the plain path, no kernel) "
                         "instead of the reference-parity quirks")
    ap.add_argument("--N", type=int, default=64,
                    help="resolution for PulsatileBloodFlow2D")
    ap.add_argument("--scheme", default="li2014",
                    choices=["li2014", "guo2015", "huber2015", "none"],
                    help="combustion: conjugate-heat scheme")
    ap.add_argument("--topology", default="inflow_outflow",
                    choices=["inflow_outflow", "cavity", "couette",
                             "poiseuille"],
                    help="combustion: domain topology (reference global "
                         "flags, CooLBM_MRT_combustion.cpp:154-254)")
    ap.add_argument("--u-lid", type=float, default=None,
                    help="combustion: lid/moving-wall speed for cavity and "
                         "couette (default 0.002 there, 0 elsewhere)")
    ap.add_argument("--dpdx", type=float, default=0.0,
                    help="combustion: body force for poiseuille")
    ap.add_argument("--restart", default=None, metavar="INI_F",
                    help="combustion: warm-start the flow from a "
                         "reference-format ini_f.dat (skips the "
                         "flow-convergence stage)")
    ap.add_argument("--bench", action="store_true",
                    help="combustion: the reference's bench mode (flow "
                         "only, 1000 warm-up steps, MLUPS over 1000 more)")
    ap.add_argument("--scalar-steps", type=int, default=5000,
                    help="combustion: reactive-stage step count")
    ap.add_argument("--nx", type=int, default=420,
                    help="combustion lattice width (reference N_X = 420)")
    ap.add_argument("--ny", type=int, default=80,
                    help="combustion lattice height (reference N_Y = 80)")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="write a torch.profiler Chrome trace of the run "
                         "(kernels, every thread's mlbm.* spans, counters) "
                         "to PATH and print the set-up phases (init, "
                         "init.upload, device.context, library.load, "
                         "library.build, kernel.first, driver: count and "
                         "seconds) and the device's idle time by span")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("coolbm: no CUDA device is visible; pass --device cpu to run "
              "the plain PyTorch path on the CPU", file=sys.stderr)
        return 2
    dtype = torch.float32 if args.f32 else torch.float64
    if args.problem == "PulsatileBloodFlow2D":
        run = functools.partial(
            apps.run_pulsatile, args.outdir, N=args.N, dtype=dtype,
            max_steps=args.steps, momentum_quirk=not args.quirk_free,
            device=device)
    elif args.problem == "combustion":
        run = functools.partial(
            apps.run_combustion, args.outdir, nx=args.nx, ny=args.ny,
            dtype=dtype, flow_steps=args.steps or 20000,
            scalar_steps=args.scalar_steps, conj_scheme=args.scheme,
            restart=args.restart, benchmark=args.bench,
            topology=args.topology, u_lid=args.u_lid, dpdx=args.dpdx,
            device=device)
    else:
        fn, config_name = PROBLEMS[args.problem]
        cfg = args.config
        if cfg is None:
            cand = CONFIG_DIR / config_name
            if not cand.exists():
                ap.error(f"--config required for {args.problem}")
            cfg = str(cand)
        run = functools.partial(fn, cfg, args.outdir, dtype=dtype,
                                max_steps=args.steps, device=device)
    if args.profile is None:
        run()
    else:
        _profile(run, args.profile)
    return 0


def _profile(run, path):
    """``run()`` under :func:`..utils.profiling.profile_run`, then the
    set-up phases and the device's idle time by driver span on stdout."""
    _, idle = profiling.profile_run(run, path)
    print(f"profile: trace written to {path}")
    print("profile: phases (name, count, seconds):")
    spans = profiling.spans()
    for name in profiling.PHASES:
        done = [s.t1 - s.t0 for s in spans
                if s.name == name and s.t1 is not None]
        if done:
            print(f"profile:   {name} {len(done)} {sum(done):.6f}")
    if not idle:
        print("profile: no driver loop or no device operation in the trace")
        return
    print(f"profile: device idle {100 * idle['idle_share']:.2f}% of "
          f"{idle['window_s'] * 1e3:.3f} ms (first kernel.enqueue to the end "
          f"of the last chunk); idle ms by driver span:")
    for name, sec in idle["idle_s_by_span"].items():
        print(f"profile:   {name} {sec * 1e3:.3f}")
    print("profile: longest idle gaps (span, ms):")
    for name, sec, _ in idle["longest"]:
        print(f"profile:   {name} {sec * 1e3:.3f}")
    print(f"profile: counters {json.dumps(profiling.counters())}")


if __name__ == "__main__":
    sys.exit(main())
