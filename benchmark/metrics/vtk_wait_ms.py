"""Driver-thread ms inside Driver.write_vtk a dump (staging the host copies
and waiting on the bound of two dumps in flight), over the dumps that start
in the traced slice."""


def read(run):
    if run.slice_bounds is None:
        return None
    t0, t1 = run.slice_bounds
    d = [b - a for n, a, b in run.spans if n == "vtk" and t0 <= a < t1]
    return 1e3 * sum(d) / len(d) if d else None
