"""Driver-thread ms a record spends in the program's ``record.interface``
span (the SC-RT record's copy of the whole density field to the host and
the scan of two of its columns): the mean over the spans that start in the
traced slice.  None where the program records no such span."""
from benchmark import program_trace


def read(run):
    got = program_trace.in_slice(run)
    if got is None:
        return None
    d = [s.t1 - s.t0 for s in program_trace.driver_spans(got[0])
         if s.name == "record.interface"]
    return 1e3 * sum(d) / len(d) if d else None
