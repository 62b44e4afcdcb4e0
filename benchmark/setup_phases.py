"""The program's set-up phases around the timed call, read by the metrics
that split ``setup_s`` (``init_state_s``, ``first_use_s``,
``setup_outside_s``).

The port records phases of a process's set-up whether or not the profiler
runs (``multiphase_lbm_tpu_torch.utils.profiling.phase``): spans with
``name``, ``parent``, ``thread``, ``t0``, ``t1`` and ``attrs`` on the
``time.perf_counter`` clock of ``benchmark/run.py``'s ``T_START`` and of
the slice bounds, in the recorder's ``spans()``.  Each driver call records
``init`` (from its entry to its ``Driver``) and ``driver`` (from its
``Driver`` to ``finish``); the card's first use records ``device.context``,
``library.load`` (``library.build`` inside it when a compiler runs) and
each entry point's ``kernel.first``.  The timed call's ``driver`` phase is
the one that holds the start of the traced slice, so these metrics are
read in the traced run.  A program without phases, or a run without a
slice, gives None.
"""
from __future__ import annotations

from benchmark import program_trace


def timed_call(run):
    """``(spans, timed)``: the recorder's closed spans and the timed call's
    ``driver`` phase, or None."""
    rec = program_trace.recorder(run)
    if rec is None or run.slice_bounds is None:
        return None
    start = run.slice_bounds[0]
    spans = [s for s in rec.spans() if s.t1 is not None]
    held = [s for s in spans if s.name == "driver" and s.t0 <= start < s.t1]
    return (spans, held[-1]) if held else None
