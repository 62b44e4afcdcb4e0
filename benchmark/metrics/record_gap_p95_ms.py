"""The 95th percentile of the wall time between consecutive diagnostic
records of the timed call, in ms, as ``interval_p95_ms`` reads it, for the
cells whose record interval is set by the host (the ASCII writer holding
the interpreter lock) and whose tail swings too far from run to run to
carry a bound.  Read in the traced run: the gaps that overlap the
profiler's slice (its start, its stop and the slower launches inside it)
are left out.  None under 20 gaps."""
import numpy as np

MIN_INTERVALS = 20


def read(run):
    t = np.asarray(run.records)
    a, b = t[:-1], t[1:]
    if run.slice_bounds is not None:
        t0, t1 = run.slice_bounds
        keep = (b < t0) | (a > t1)
        a, b = a[keep], b[keep]
    if len(a) < MIN_INTERVALS:
        return None
    return float(np.percentile(b - a, 95) * 1e3)
