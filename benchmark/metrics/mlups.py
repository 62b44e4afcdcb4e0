"""Lattice-site updates per second of the timed driver call, in millions:
cells × steps ÷ the call's wall time in µs (the reference's printMlups)."""


def read(run):
    return run.nelem * run.steps / (run.window_s * 1e6)
