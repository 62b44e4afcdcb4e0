"""The program's own spans and counts inside the traced slice.

The port records spans and counted events only while ``torch.profiler``
records on the thread (``multiphase_lbm_tpu_torch.utils.profiling``:
``spans()``, each with ``name``, ``parent``, ``thread``, ``t0``, ``t1`` and
``attrs`` on the ``time.perf_counter`` clock, and ``count_events()``, each
``(t, name, n)``).  The benchmark's slice bounds are on the same clock, so
the slice's share is what starts inside them.  A program without the
recorder gives None, and so does a run without a slice; the metrics that
read this module then report nothing.  A run namespace may carry its own
``recorder`` with those two functions (the self-test's synthetic one).
"""
from __future__ import annotations

import importlib


def recorder(run):
    """The run's recorder, the program's, or None where it has none."""
    rec = getattr(run, "recorder", None)
    if rec is not None:
        return rec
    try:
        rec = importlib.import_module("multiphase_lbm_tpu_torch.utils.profiling")
    except ImportError:
        return None
    return rec if hasattr(rec, "spans") and hasattr(rec, "count_events") else None


def in_slice(run):
    """``(spans, events)``: the closed spans and the counted events that
    start inside the traced slice, or None."""
    rec = recorder(run)
    if rec is None or run.slice_bounds is None:
        return None
    t0, t1 = run.slice_bounds
    spans = [s for s in rec.spans() if s.t1 is not None and t0 <= s.t0 < t1]
    events = [e for e in rec.count_events() if t0 <= e[0] < t1]
    return spans, events


def driver_spans(spans):
    """The spans of the driver's thread: the thread of the ``record`` and
    ``chunk`` spans."""
    loop = [s for s in spans if s.name in ("record", "chunk")]
    if not loop:
        return []
    thread = loop[0].thread
    return [s for s in spans if s.thread == thread]


def records(spans):
    """The driver's ``record`` spans, in the order they started."""
    return sorted((s for s in driver_spans(spans) if s.name == "record"),
                  key=lambda s: s.t0)
