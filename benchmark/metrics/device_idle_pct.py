"""Percent of the traced slice's host wall time in which no operation ran
on the device: 1 − busy ÷ wall."""


def read(run):
    s = run.slice
    if s is None:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
