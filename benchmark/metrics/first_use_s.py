"""Seconds the process spends once on the card before the window, from the
program's own phases (``benchmark/setup_phases.py``) that start before the
timed call's ``driver`` phase, on any thread: the first CUDA context
(``device.context``), each library's load less the compiler inside it
(``library.load`` less its ``library.build`` children: nvcc stays in the
first run's set-up) and each entry point's first C call, where the
runtime loads its module (``kernel.first``).  Read in the traced run."""
from benchmark import setup_phases

ONCE = ("device.context", "library.load", "kernel.first")


def read(run):
    got = setup_phases.timed_call(run)
    if got is None:
        return None
    spans, timed = got
    before = [s for s in spans if s.t0 < timed.t0]
    once = sum(s.t1 - s.t0 for s in before if s.name in ONCE)
    built = sum(s.t1 - s.t0 for s in before if s.name == "library.build"
                and s.parent is not None and s.parent.name == "library.load")
    return once - built
