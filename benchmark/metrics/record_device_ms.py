"""Device ms a record of the kernels launched outside the benchmark's span
around the stepping entry (the trace's ``span_kernel_s`` outside ``step``:
the record's plain kernels), over the program's ``record.energy`` spans
that started in the traced slice.  None where the program records no such
span, or the slice holds none."""
from benchmark import program_trace


def read(run):
    got = program_trace.in_slice(run)
    if got is None or run.slice is None:
        return None
    n = sum(1 for s in program_trace.driver_spans(got[0]) if s.name == "record.energy")
    if not n:
        return None
    outside = sum(v for k, v in run.slice["span_kernel_s"].items() if k != "step")
    return 1e3 * outside / n
