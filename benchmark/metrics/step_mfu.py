"""Share of the card's peak that the whole step reaches: the kernel
family's bound a step (counted bytes or operations over the data-sheet
rate), times the steps of the traced slice, over the slice's host wall
time, diagnostics, dumps and idle time included.  It bounds every kernel's
roofline share from below whichever kernels the step runs."""
from benchmark import roofline


def read(run):
    s = run.slice
    if s is None:
        return None
    t, _ = roofline.bound_s(run)
    return 100.0 * t * s["steps"] / s["window_s"]
