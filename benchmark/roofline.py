"""The yardstick of the kernels: counted bytes and operations a step from
the work files, and the data-sheet peaks (``peaks.json``).  The counts are
the benchmark's own; the program's ``WORK_PER_CELL`` constants are not
read."""
from __future__ import annotations


def bound_s(run):
    """(seconds, "bytes" | "operations"): the least time one step of the
    cell's kernel family could take on the card, the larger of its counted
    bytes over the memory rate and its counted operations over the
    floating-point rate of its dtype."""
    work, peaks = run.spec.work, run.spec.peaks
    per = work["bytes_per_cell"][run.dtype]
    nbytes = run.nelem * (per["populations"] + (per["mask"] if run.spec.config["work"]["mask"] else 0))
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    t_ops = run.nelem * work["flop_per_cell"] / peaks["flop_per_s"][run.dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_share(run, family):
    """Percent of the bound that the kernels launched inside the benchmark's
    span around the stepping entry reach, over the traced slice; None where
    the cell does not run ``family`` or the slice saw no such kernel."""
    s = run.slice
    if s is None or run.spec.config["work"]["family"] != family:
        return None
    device_s = s["span_kernel_s"].get("step")
    if not device_s:
        return None
    t, _ = bound_s(run)
    return 100.0 * t * s["steps"] / device_s
