"""Seconds of ``setup_s`` outside the program's own phases: ``setup_s``
less the union of the ``init`` and ``driver`` phases of the driver's
thread that end before the timed call's ``driver`` phase starts
(``benchmark/setup_phases.py``): each warm-up call's ``init`` and
``driver`` and the timed call's ``init``.  What remains is the
interpreter's imports, the harness, and, since this is read in the traced
run, the profiler's warm-up; no change to the program moves it."""
from benchmark import setup_phases


def read(run):
    got = setup_phases.timed_call(run)
    if got is None:
        return None
    spans, timed = got
    mine = sorted((s.t0, s.t1) for s in spans if s.name in ("init", "driver")
                  and s.thread == timed.thread and s.t1 <= timed.t0)
    covered, end = 0.0, float("-inf")
    for t0, t1 in mine:
        if t1 > end:
            covered += t1 - max(t0, end)
            end = t1
    return run.setup_s - covered
