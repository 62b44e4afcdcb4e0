"""Driver-thread ms a record leaves the device without queued work: from
the end of the record's last ``wait`` (its last blocking read of device
data) to the start of the next ``kernel.enqueue``, the host work between
them (the logs, the host's scan of the read data, the next call's
preparation).  Mean over the records of the traced slice that have both,
from the program's own spans.  A slice of one record interval (records
every 3200 steps) has none: its one record is its last, and the profiler
stops before the next call enqueues."""
import bisect

from benchmark import program_trace


def read(run):
    got = program_trace.in_slice(run)
    if got is None:
        return None
    mine = program_trace.driver_spans(got[0])
    enqueues = sorted(s.t0 for s in mine if s.name == "kernel.enqueue")
    exposed = []
    for r in program_trace.records(got[0]):
        ends = [s.t1 for s in mine if s.name == "wait" and r.t0 <= s.t0 <= r.t1]
        if not ends:
            continue
        i = bisect.bisect_left(enqueues, max(ends))
        if i < len(enqueues):
            exposed.append(enqueues[i] - max(ends))
    return 1e3 * sum(exposed) / len(exposed) if exposed else None
