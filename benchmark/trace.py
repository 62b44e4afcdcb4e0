"""Reduction of the profiler's slice to device busy time, kernel counts,
the kernels launched inside a host span, the device's longest idle gaps
named by the host span they fall in, and the device operations that took
most time.

The arithmetic of busy time and idle share is that of the program's
``utils/profiling.device_profile`` (busy = device time of the operations,
idle = 1 − busy ÷ host wall time of the slice), copied here so that the
yardstick stays with the benchmark; busy time is the union of the
operations' intervals, so overlapping copies are not counted twice.
Kernels are tied to the host span that launched them through the
profiler's correlation ids.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

from .hooks import SPAN_PREFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# a templated kernel's name runs to a thousand characters; its head names it
NAME_CHARS = 160
# the span a gap is named after when the host was in none of the
# benchmark's spans: the driver's own code between them, its diagnostics
OUTSIDE = "diagnostics"


def events(prof):
    """The slice's events, as the profiler's Chrome trace holds them."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Spans:
    """The benchmark's spans on the driver's thread, in the trace's clock.
    They do not nest there (step, log and vtk follow one another)."""

    def __init__(self, events):
        marks = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith(SPAN_PREFIX)]
        main = next((e["tid"] for e in marks if e["name"] == SPAN_PREFIX + "step"), None)
        self.items = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"][len(SPAN_PREFIX):])
                            for e in marks if e["tid"] == main)
        self.starts = [s[0] for s in self.items]

    def at(self, t):
        """The span covering host time ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.items[i][1]:
            return self.items[i][2]
        return None


def reduce(events, wall_s: float, steps: int) -> dict:
    """The slice's readings: ``busy_s``, ``window_s``, ``steps``,
    ``kernels`` (count), ``span_kernel_s`` (device seconds of the kernels
    launched inside each span), ``device_ops`` and ``idle_gaps`` (the ten
    largest, as ``[name, seconds]``)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    spans = _Spans(events)
    span_kernel_us = defaultdict(float)
    by_name = defaultdict(float)
    kernels = 0
    for e in dev:
        by_name[e["name"]] += e["dur"]
        if e["cat"] != "kernel":
            continue
        kernels += 1
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        span_kernel_us[(spans.at(t) if t is not None else None) or OUTSIDE] += e["dur"]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    gaps = []
    for (_, end), (start, _) in zip(busy, busy[1:]):
        name = spans.at(0.5 * (end + start)) or OUTSIDE
        gaps.append([name, (start - end) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(([n[:NAME_CHARS], us * 1e-6] for n, us in by_name.items()),
                 key=lambda o: -o[1])
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": wall_s,
            "steps": steps, "kernels": kernels,
            "span_kernel_s": {k: v * 1e-6 for k, v in span_kernel_us.items()},
            "device_ops": ops[:10], "idle_gaps": gaps[:10]}
