"""Seconds of the timed call's ``init`` phase: the driver's case file,
parameters, geometry and initial state (its host→card copies are the
``init.upload`` phases inside it), from the driver's entry to its
``Driver``.  It is the last ``init`` of the driver's thread that starts
before the timed call's ``driver`` phase (``benchmark/setup_phases.py``),
from the program's own phases, read in the traced run."""
from benchmark import setup_phases


def read(run):
    got = setup_phases.timed_call(run)
    if got is None:
        return None
    spans, timed = got
    inits = [s for s in spans if s.name == "init" and s.thread == timed.thread
             and s.t0 < timed.t0]
    if not inits:
        return None
    last = max(inits, key=lambda s: s.t0)
    return last.t1 - last.t0
