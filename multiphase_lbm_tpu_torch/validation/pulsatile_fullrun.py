"""Full-run statistical regression for the pulsatile vessel.

Port of ``multiphase_lbm_tpu/validation/pulsatile_fullrun.py``.  The
reference ships a complete run of the severed compliant-vessel case (103
``sol_*.vtk`` dumps to t = 2754); early steps match bit-near-exactly, but
over the whole run the near-closed inlet region is chaotic (staircase wall
decisions amplify rounding noise), so the whole-run comparison is
statistical: the wall-position envelope, the inlet pressure wave's
amplitude and phase at a probe column, and fluid-masked field statistics.

:func:`golden_metrics` reads the archived run where it exists (``GOLD``,
under ``reference/`` of the repository).  Where it does not, the port's
float64 plain run, in the kernel's arithmetic, stands in for it
(:func:`reference_metrics`).  The kernel's float32 run and eight float32
runs perturbed by an ulp are held, by their medians, to the metrics of
``GATES_F32`` named in ``GATED_F32``; every run to the ±1-dump phase lag;
and the unperturbed run to the JAX envelope on order-dependent reseed
steps (:func:`run_gate`).  The late-regime metrics turn on one chaotic
trajectory: float64 runs whose initial populations differ by an ulp
disagree on them beyond their gates (:func:`self_check`), so they are
printed and not gated.

    python -m multiphase_lbm_tpu_torch.validation.pulsatile_fullrun [--device cpu]

prints the gate (every metric of each run's table: min, median, max) and
the self-check.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..models import pulsatile as pm

# the reference's archived run, where it is unpacked beside the packages
GOLD = (Path(__file__).resolve().parents[2] / "reference" / "Abbashub LBM"
        / "out_single-phase fluid flow through a compliant vessel")
DUMP_EVERY = 27
N_DUMPS = 103
PROBE_X = 31          # inlet-region probe column (past the severed throat)


def _dump_indices(cadence):
    # dump 1 (t=27) is always included: it anchors the early regime
    return sorted({0, 1} | set(range(0, N_DUMPS, cadence)))


def golden_metrics(cadence=1):
    """The metric set of every ``cadence``-th archived dump; raises when
    the archived run is absent."""
    from ..io import vtk

    if not GOLD.exists():
        raise FileNotFoundError(f"the archived reference run is absent: {GOLD}")
    out = []
    for i in _dump_indices(cadence):
        t = i * DUMP_EVERY
        g = vtk.read_vtk_fields(GOLD / f"sol_{t:07d}.vtk")
        fluid = g["Flag"].astype(int) == 0
        out.append(_metrics(g["P"], g["Ux"], fluid, t))
    return out


def _metrics(P, Ux, fluid, t):
    ny, nx = P.shape
    cols = fluid.sum(axis=0)                      # fluid extent per column
    rows = np.arange(ny)[:, None]
    lo = np.where(fluid, rows, ny).min(axis=0)    # first fluid row
    hi = np.where(fluid, rows, -1).max(axis=0)    # last fluid row
    m = fluid.sum() > 0
    Pm = P[fluid].mean() if m else 0.0
    Ps = P[fluid].std() if m else 0.0
    Um = Ux[fluid].mean() if m else 0.0
    Us = np.abs(Ux[fluid]).max() if m else 0.0
    pc = fluid[:, PROBE_X]
    P_probe = P[pc, PROBE_X].mean() if pc.any() else 0.0
    return dict(t=t, extent=cols, lo=lo, hi=hi, P_mean=Pm, P_std=Ps,
                Ux_mean=Um, Ux_absmax=Us, P_probe=P_probe)


def _initial_state(p, dt, device, perturb, seed):
    """The reference case's initial state; ``perturb`` > 0 multiplies every
    population by 1 + perturb·ε·u, u uniform in (−1, 1) from ``seed`` and ε
    the working type's machine epsilon (a change of about ``perturb`` ulps)."""
    st = pm.initialize(p, dt, device=device)
    if not perturb:
        return st
    u = np.random.default_rng(seed).uniform(-1.0, 1.0, tuple(st.g_coll.shape))
    u = torch.from_numpy(u).to(device=device, dtype=dt)
    g = st.g_coll * (1.0 + perturb * torch.finfo(dt).eps * u)
    return st._replace(g_coll=g, g_stream=g.clone())


def simulate_metrics(dtype="f64", cadence=1, progress=False, path="plain",
                     device="cuda", perturb=0, seed=0):
    """Run the full 2765-step reference case (N = 64) and collect the metrics
    at every ``cadence``-th dump instant.  ``path="kernel"`` advances through
    the CUDA kernel (:mod:`..ops.pulsatile_fused`) after the first step, as
    the JAX fused path does, in float32 unless ``dtype`` says otherwise;
    ``path="plain"`` runs the plain path, in the kernel's arithmetic.
    ``perturb`` and ``seed``: see :func:`_initial_state`.

    Returns ``(metrics, diag)``; for the kernel path ``diag`` totals the
    kernel's counters over the run: ``order_dep_steps`` (reseed steps that
    were order-dependent and filled densely instead of sequentially) and
    ``reseed_cells``.  ``diag`` is None for the plain path, whose
    sequential fallback is exact."""
    from ..ops import pulsatile_fused as pf

    device = torch.device(device)
    if path not in ("plain", "kernel"):
        raise ValueError(f"path must be 'plain' or 'kernel', got {path!r}")
    dt = torch.float64 if dtype == "f64" else torch.float32
    N = 64
    p = pm.PulsatileParams(nx=1 + 10 * (N - 2), ny=N)
    st = _initial_state(p, dt, device, perturb, seed)
    st = pm.step(st, 0, p)                      # dump 0: after 1 step
    out = []
    diag = ({"order_dep_steps": 0, "reseed_cells": 0} if path == "kernel"
            else None)
    keep = set(_dump_indices(cadence))
    for i in range(N_DUMPS):
        t = i * DUMP_EVERY
        if i:
            t0 = 1 + (i - 1) * DUMP_EVERY
            if path == "kernel":
                st, dg = pf.run_fused_full(st, t0, p, DUMP_EVERY)
                diag["order_dep_steps"] += int(dg[0])
                diag["reseed_cells"] += int(dg[1])
            else:
                st = pm.run(st, t0, p, DUMP_EVERY)
        if i in keep:
            out.append(_metrics(st.P.double().cpu().numpy(),
                                st.Ux.double().cpu().numpy(),
                                st.fluid.cpu().numpy(), t))
            if progress and i % 20 == 0:
                print(f"  dump {i}/{N_DUMPS}", flush=True)
    return out, diag


def reference_metrics(device="cuda", progress=False):
    """The metrics the kernel's run is held to: the archived run where it
    exists, else the port's float64 plain run."""
    if GOLD.exists():
        return golden_metrics()
    return simulate_metrics("f64", path="plain", device=device,
                            progress=progress)[0]


def compare(sim, gold):
    """Comparison table (see the JAX module for the three regimes of the
    run: early bit-near-exact, chaotic transient, late re-convergence)."""
    assert len(sim) == len(gold)

    def wall_err(s, g):
        # an all-solid column has lo = ny, hi = -1; solid in only one run
        # counts as an O(ny) wall disagreement
        return np.maximum(np.abs(s["lo"] - g["lo"]),
                          np.abs(s["hi"] - g["hi"])).astype(float)

    n = len(sim)
    early = [i for i in range(n) if sim[i]["t"] <= 27]
    late = [i for i in range(n) if sim[i]["t"] >= 2580]
    wall_all = np.concatenate([wall_err(sim[i], gold[i]) for i in range(n)])
    wall_early = np.concatenate([wall_err(sim[i], gold[i])
                                 for i in early]) if early else wall_all
    wall_late = np.concatenate([wall_err(sim[i], gold[i])
                                for i in late]) if late else wall_all
    dP_late = max(abs(sim[i]["P_mean"] - gold[i]["P_mean"])
                  for i in late) if late else 0.0
    dUx_late = max(abs(sim[i]["Ux_absmax"] - gold[i]["Ux_absmax"])
                   for i in late) if late else 0.0

    Pp_sim = np.array([s["P_probe"] for s in sim])
    Pp_gold = np.array([g["P_probe"] for g in gold])
    # oscillatory tail (Pin waveform active after t_start ≈ 2144)
    k0 = next((i for i in range(n) if sim[i]["t"] >= 2144), n - 4)
    amp_s = Pp_sim[k0:].max() - Pp_sim[k0:].min()
    amp_g = Pp_gold[k0:].max() - Pp_gold[k0:].min()
    a = Pp_sim[k0:] - Pp_sim[k0:].mean()
    b = Pp_gold[k0:] - Pp_gold[k0:].mean()
    lags = range(-3, 4)
    cc = [np.correlate(np.roll(a, lag), b)[0] for lag in lags]
    lag = list(lags)[int(np.argmax(cc))]
    rms_tail = float(np.sqrt(((Pp_sim[k0:] - Pp_gold[k0:]) ** 2).mean()))
    return {
        "probe_rms_tail": rms_tail,
        "wall_early_max_err": float(wall_early.max()),
        "wall_late_max_err": float(wall_late.max()),
        "wall_global_mean_err": float(wall_all.mean()),
        "P_mean_late_err": float(dP_late),
        "Ux_absmax_late_err": float(dUx_late),
        "wave_amp_rel_err": float(abs(amp_s - amp_g)
                                  / max(abs(amp_g), 1e-12)),
        "wave_phase_lag_dumps": int(lag),
        "probe_rms": float(np.sqrt(((Pp_sim - Pp_gold) ** 2).mean())),
    }


# the JAX module's tolerances (~2× its measured f64 deviations)
GATES = {
    "wall_early_max_err": 1.0,       # cells — bit-near-exact regime
    "wall_late_max_err": 2.0,        # cells — re-converged regime
    "wall_global_mean_err": 3.0,     # cells incl. the chaotic transient
    "P_mean_late_err": 1e-3,         # pressure LU (p_osc = 2e-3)
    "Ux_absmax_late_err": 2e-3,
    "wave_amp_rel_err": 0.1,
    "probe_rms": 3e-4,
}

# float32 production paths: no bit-exact early regime, looser late walls,
# anchored on the inlet pressure wave and the late field values
GATES_F32 = {
    "wall_late_max_err": 4.0,
    "wall_global_mean_err": 3.0,
    "P_mean_late_err": 1e-3,
    "Ux_absmax_late_err": 2e-3,
    "wave_amp_rel_err": 0.1,
    "probe_rms_tail": 1e-3,
}

# envelope on the kernel's one documented deviation from the plain path:
# order-dependent reseed steps filled densely (the JAX fused kernel measured
# 6 in the full f32 run; gated at 2×)
ORDER_DEP_STEPS_MAX = 12


# The GATES_F32 metrics the kernel's float32 runs are held to: those that
# runs of the reference case perturbed by an ulp in their initial
# populations keep well inside their gates (:func:`self_check`).  The
# late-regime metrics turn on one chaotic trajectory and are printed, not
# gated.
GATED_F32 = ("wall_global_mean_err", "wave_amp_rel_err", "probe_rms_tail")
SELF_RUNS = 8         # perturbed runs of the gate and of its self-check


def check(table, gates=GATES, shown=()):
    """Print every metric beside its gate, and the metrics named in
    ``shown`` as not gated; True when all gates pass, the ±1-dump phase
    lag included."""
    ok = True
    for k, tol in gates.items():
        v = table[k]
        good = v <= tol
        ok &= good
        print(f"  {k}: {v:.5g} (tol {tol}) {'PASS' if good else 'FAIL'}")
    for k in shown:
        if k not in gates:
            print(f"  {k}: {table[k]:.5g} (not gated: chaotic)")
    lag_ok = abs(table["wave_phase_lag_dumps"]) <= 1
    print(f"  wave_phase_lag_dumps: {table['wave_phase_lag_dumps']}"
          f" (tol ±1) {'PASS' if lag_ok else 'FAIL'}")
    return ok and lag_ok


def kernel_runs(dtype="f32", runs=SELF_RUNS, device="cuda"):
    """``(sims, diag)``: the metrics of the kernel's run of the reference
    case and of ``runs`` runs of it perturbed by an ulp (seeds 1 … runs),
    and the unperturbed run's diag counters."""
    sims = []
    for seed in range(runs + 1):
        sim, dg = simulate_metrics(dtype, path="kernel", device=device,
                                   perturb=int(seed > 0), seed=seed)
        sims.append(sim)
        diag = dg if seed == 0 else diag
    return sims, diag


def spread(sims, reference):
    """``{metric: [value, ...]}``: :func:`compare` of each run against
    ``reference``."""
    out = {}
    for sim in sims:
        for k, v in compare(sim, reference).items():
            out.setdefault(k, []).append(v)
    return out


def print_spread(values, title):
    """One line per metric: min, median and max over the runs beside the
    GATES_F32 tolerance."""
    print(title)
    for k, v in values.items():
        a = np.asarray(v, dtype=float)
        print(f"  {k}: min {a.min():.5g}, median {np.median(a):.5g}, "
              f"max {a.max():.5g} (GATES_F32 {GATES_F32.get(k, '-')})")


def run_gate(sims, diag, reference):
    """The float32 runs of :func:`kernel_runs` against ``reference``: the
    median over the runs of each ``GATED_F32`` metric within its gate, the
    phase lag of every run within ±1 dump, and the order-dependent
    envelope of the unperturbed run.  Returns ``(ok, medians)``."""
    values = spread(sims, reference)
    print_spread(values, f"the float32 run and {len(sims) - 1} runs "
                         "perturbed by an ulp, against the reference:")
    table = {k: float(np.median(v)) for k, v in values.items()}
    table["wave_phase_lag_dumps"] = max(values["wave_phase_lag_dumps"],
                                        key=abs)
    print("medians (the phase lag: the largest):")
    ok = check(table, {k: GATES_F32[k] for k in GATED_F32}, GATES_F32)
    n = diag["order_dep_steps"]
    dep_ok = n <= ORDER_DEP_STEPS_MAX and diag["reseed_cells"] > 0
    print(f"  order_dep_reseed_steps: {n} (tol {ORDER_DEP_STEPS_MAX}), "
          f"reseeded cells {diag['reseed_cells']} (> 0) "
          f"{'PASS' if dep_ok else 'FAIL'}")
    return ok and dep_ok, table


def self_check(sims, reference):
    """The gate's premise, from the float64 runs of :func:`kernel_runs`:
    the perturbed runs against the unperturbed one keep the ``GATED_F32``
    metrics inside half their gates and the phase lag within ±1 dump.
    Also printed: the unperturbed run against ``reference``, from which it
    departs on the order-dependent reseed steps that it fills densely.
    Returns ``(ok, spread)``."""
    print("kernel float64 against the reference: " + ", ".join(
        f"{k} {v:.3g}" for k, v in compare(sims[0], reference).items()))
    values = spread(sims[1:], sims[0])
    print_spread(values, f"{len(sims) - 1} float64 runs perturbed by an "
                         "ulp, against the unperturbed one:")
    ok = all(max(values[k]) <= 0.5 * GATES_F32[k] for k in GATED_F32)
    ok &= max(abs(v) for v in values["wave_phase_lag_dumps"]) <= 1
    return ok, values


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pulsatile_fullrun")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("pulsatile_fullrun: no CUDA device is visible; pass --device "
              "cpu", file=sys.stderr)
        return 2
    reference = reference_metrics(args.device, progress=True)
    ok, _ = run_gate(*kernel_runs("f32", device=args.device), reference)
    premise, _ = self_check(kernel_runs("f64", device=args.device)[0],
                            reference)
    print("RESULT:", "PASS" if ok and premise else "FAIL")
    return 0 if ok and premise else 1


if __name__ == "__main__":
    sys.exit(main())
