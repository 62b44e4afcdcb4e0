"""Device kernels of the traced slice, those of the diagnostics and dumps
included, per lattice step of the slice."""


def read(run):
    s = run.slice
    if s is None or not s["kernels"]:
        return None
    return s["kernels"] / s["steps"]
