"""Writer-thread ms inside VtkWriter.write (formatting and the disk write)
a dump, over the dumps that start in the traced slice."""


def read(run):
    if run.slice_bounds is None:
        return None
    t0, t1 = run.slice_bounds
    d = [b - a for n, a, b in run.spans if n == "vtk_write" and t0 <= a < t1]
    return 1e3 * sum(d) / len(d) if d else None
