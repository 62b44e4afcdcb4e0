"""Throughput measurement: MLUPS of a function that advances n steps.

Port of ``multiphase_lbm_tpu/utils/profiling.py``.  MLUPS keeps the
reference's definition (``printMlups``: nelem · steps / µs).  A reading on a
CUDA tensor is taken on the host clock after ``torch.cuda.synchronize()``;
the relay workarounds of the JAX version (perturbed inputs, host
readbacks) are not needed.  Two faults of the JAX slope reading are fixed:
``n2 <= n1`` is refused, and a per-step time ≤ 0 (noise larger than the
work) is returned as an invalid reading with no rate, never published.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch


def _sync(out):
    """Wait for the device work behind ``out``: a tensor or a tuple of
    tensors (a two-distribution state)."""
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


def _timed(fn, state0, reps):
    """Median wall time of ``reps`` calls of ``fn(state0)``, each ending in a
    device synchronise, their spread (max − min) / median, and the last
    output."""
    dts, out = [], None
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        out = fn(state0)
        _sync(out)
        dts.append(time.perf_counter() - t0)
    dt = float(np.median(dts))
    return dt, float((max(dts) - min(dts)) / dt), out


@dataclasses.dataclass
class Reading:
    """One throughput reading.  ``mlups`` and ``ms_per_step`` are None when
    ``valid`` is False."""
    mlups: Optional[float]
    ms_per_step: Optional[float]
    spread: float
    valid: bool
    out: Any
    overhead_ms: Optional[float] = None


def measure_mlups(step_n_fn, state0, n_steps: int, nelem: int,
                  reps: int = 3) -> Reading:
    """One-shot throughput of ``step_n_fn`` (advances ``n_steps``): one warm
    call, then the median of ``reps`` timed calls on ``state0``."""
    _sync(step_n_fn(state0))
    dt, spread, out = _timed(step_n_fn, state0, reps)
    return Reading(nelem * n_steps / dt / 1e6, dt * 1e3 / n_steps, spread,
                   True, out)


def device_profile(step_n_fn, state0, n_steps: int) -> dict:
    """One call of ``step_n_fn(state0)`` (advancing ``n_steps``) under
    ``torch.profiler`` after a warm call: device time per step by kernel
    name, the device's busy time per step and its idle share of the host
    wall time of the call (which ends in a device synchronise)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(step_n_fn(state0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _sync(step_n_fn(state0))
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        # device-side events only: an aten op's own row repeats the time
        # of the kernels it launched
        if e.device_type == DeviceType.CPU:
            continue
        us = e.self_device_time_total
        if us > 0:
            kernels.append({"name": e.key[:96], "ms_per_step": us / 1e3 / n_steps,
                            "calls_per_step": e.count / n_steps})
    kernels.sort(key=lambda k: -k["ms_per_step"])
    busy = sum(k["ms_per_step"] for k in kernels)
    return {"steps": n_steps, "wall_ms_per_step": wall_ms / n_steps,
            "device_busy_ms_per_step": busy,
            "idle_share": max(0.0, 1.0 - busy * n_steps / wall_ms),
            "kernels": kernels[:12]}


def measure_mlups_slope(make_step_fn, state0, n1: int, n2: int, nelem: int,
                        reps: int = 3) -> Reading:
    """Two-point slope throughput: cancels the constant per-call cost.

    ``make_step_fn(n)`` returns a function advancing ``n`` steps.  Each of
    the two step counts is warmed once and timed as the median of ``reps``
    calls; ``per_step = (t(n2) − t(n1)) / (n2 − n1)`` and
    ``overhead_ms = t(n1) − per_step · n1``.  ``spread`` is the worse of the
    two medians' spreads; ``out`` is the output of the last ``n2`` call.
    """
    if not (isinstance(n1, int) and isinstance(n2, int) and 0 < n1 < n2):
        raise ValueError(f"slope timing needs 0 < n1 < n2, got n1={n1}, n2={n2}")
    f1, f2 = make_step_fn(n1), make_step_fn(n2)
    for fn in (f1, f2):
        _sync(fn(state0))
    t1, s1, _ = _timed(f1, state0, reps)
    t2, s2, out = _timed(f2, state0, reps)
    per = (t2 - t1) / (n2 - n1)
    spread = max(s1, s2)
    if per <= 0.0:
        return Reading(None, None, spread, False, out)
    return Reading(nelem / per / 1e6, per * 1e3, spread, True, out,
                   overhead_ms=(t1 - per * n1) * 1e3)
