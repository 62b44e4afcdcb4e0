"""Bytes the driver reads from the device to the host a record, in MB
(10^6 B): the program's ``d2h_bytes`` counted in the traced slice (the
diagnostics' blocking reads and the dumps' staged copies) over the
``record`` spans that started in it."""
from benchmark import program_trace


def read(run):
    got = program_trace.in_slice(run)
    if got is None:
        return None
    n = len(program_trace.records(got[0]))
    if not n:
        return None
    return sum(c for _, name, c in got[1] if name == "d2h_bytes") / 1e6 / n
