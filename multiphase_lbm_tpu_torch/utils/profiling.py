"""Measurement: MLUPS of a function that advances n steps, and the
program's own spans and counters.

Port of ``multiphase_lbm_tpu/utils/profiling.py``.  MLUPS keeps the
reference's definition (``printMlups``: nelem · steps / µs).  A reading on a
CUDA tensor is taken on the host clock after ``torch.cuda.synchronize()``;
the relay workarounds of the JAX version (perturbed inputs, host
readbacks) are not needed.  Two faults of the JAX slope reading are fixed:
``n2 <= n1`` is refused, and a per-step time ≤ 0 (noise larger than the
work) is returned as an invalid reading with no rate, never published.

The recorder.  :func:`span` marks a stretch of host work (a kernel
wrapper's preparation, a driver's record, a dump's formatting) and
:func:`count` adds to a named process-wide integer (kernel launches, bytes
read to the host).  A span exists only while ``torch.profiler`` records on
the calling thread: otherwise it costs one flag test and records nothing.
While it records, the span keeps ``(name, parent, thread, t0, t1, attrs)``
in memory on the ``time.perf_counter`` clock and opens a
``torch.profiler.record_function("mlbm.<name>")`` range, so that it lands
on the profiler's timeline beside the kernels it launched.  A worker thread
that runs work the traced thread handed it (the VTK writer) records its
spans under :func:`carry` of the flag the task was submitted with, since
the profiler's flag is local to a thread.  :func:`spans`, :func:`counters`,
:func:`counter`, :func:`count_events` and :func:`reset` read and clear what
was recorded; :func:`profile_run` is the operator's profile of a whole run.

A :func:`phase` is a span that records whether or not the profiler runs,
for work a driver call does a bounded number of times: the set-up a user
waits through before the first step (:data:`PHASES`).  It keeps the same
record on the same clock in the same list, and opens its
``record_function`` only while :func:`tracing`.  :func:`upload` copies an
initial state to its device inside an ``init.upload`` phase, and
:func:`device_context` makes the port's first CUDA context inside a
``device.context`` phase.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import json
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
from torch.autograd import _profiler_enabled

# the prefix of the program's ranges on the profiler's timeline
PREFIX = "mlbm."

# the phases the port records, where (see the module note):
#   init (driver, cells)       a runners/apps.run_* from its entry to the
#                              line before its Driver: case file, parameters,
#                              geometry, initial state
#   init.upload (bytes)        each host->device copy of an initial state
#   device.context (device)    the process's first CUDA context, made by
#                              the port where it first touches the card
#   driver                     a Driver from its construction until finish()
#                              has drained the dumps
#   library.load (lib)         ops/_build.load, io/vtk.load_formatter: the
#                              staleness check, CDLL and the argtypes
#   library.build (lib)        inside library.load: nvcc or cc, only when
#                              the library is stale
#   kernel.first (family, entry)  ops/_build.enqueue: the first C call of an
#                              entry point and dtype, the runtime's module load
PHASES = ("init", "init.upload", "device.context", "driver", "library.load",
          "library.build", "kernel.first")


class Span:
    """One recorded span: ``t1`` is None while it is open; ``parent`` is the
    enclosing recorded span on the same thread, or None; ``thread`` the
    native thread id (the profiler's ``tid``).  ``ranged`` opens a
    ``record_function`` range around it."""
    __slots__ = ("name", "parent", "thread", "t0", "t1", "attrs", "_range")

    def __init__(self, name, attrs, ranged=True):
        self.name, self.attrs = name, attrs
        self.parent = self.thread = self.t0 = self.t1 = None
        self._range = (torch.profiler.record_function(PREFIX + name)
                       if ranged else None)

    def __enter__(self):
        stack = _open_spans()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.thread = threading.get_native_id()
        self.t0 = time.perf_counter()
        if self._range is not None:
            self._range.__enter__()
        _SPANS.append(self)
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        self.t1 = time.perf_counter()
        stack = _open_spans()
        if self in stack:   # a span left open by an exception stays below
            stack.remove(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, parent={getattr(self.parent, 'name', None)!r}, "
                f"t0={self.t0}, t1={self.t1}, attrs={self.attrs})")


class _Off:
    """The span of a thread the profiler does not record: nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_SPANS: list = []              # every recorded Span, in the order opened
_TOTALS: dict = {}             # counter name -> int, always kept
_EVENTS: list = []             # (t, name, n) of the counts made while traced
_LOCK = threading.Lock()
_CARRIED: set = set()          # idents of the threads inside carry(True)
_LOCAL = threading.local()


def _open_spans() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def tracing() -> bool:
    """Whether spans record on the calling thread: the profiler records on
    it, or it carries the flag of a traced task."""
    return _profiler_enabled() or (bool(_CARRIED)
                                   and threading.get_ident() in _CARRIED)


def span(name: str, **attrs):
    """A context manager around host work named ``name``; see the module
    note.  ``attrs`` (numbers or short strings) are kept with it."""
    return Span(name, attrs) if tracing() else _OFF


def phase(name: str, **attrs):
    """A span around set-up work named ``name`` that records with or
    without the profiler, its ``record_function`` range only while
    :func:`tracing`; see the module note and :data:`PHASES`."""
    return Span(name, attrs, tracing())


_context_made = False


def device_context(device):
    """Make ``device``'s CUDA context inside a ``device.context`` phase the
    first time the port touches a card in this process: the runtime's
    start and the context that the first allocation, copy or kernel would
    otherwise pay for.  Nothing on the CPU, nor once it has run."""
    global _context_made
    device = torch.device(device)
    if device.type != "cuda" or _context_made:
        return
    _context_made = True
    with phase("device.context", device=str(device)):
        torch.cuda.synchronize(device)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """``torch.from_numpy(a).to(device)``, the host→device copy of an
    initial state, inside an ``init.upload`` phase with its ``bytes``; a
    CPU device records alike (nothing is copied)."""
    device_context(device)
    with phase("init.upload", bytes=a.nbytes):
        return torch.from_numpy(a).to(device)


class carry:
    """Record the spans of the work inside the block as :func:`span` would
    on the thread that submitted it, whose :func:`tracing` was ``traced``."""
    __slots__ = ("traced", "ident")

    def __init__(self, traced: bool):
        self.traced = traced

    def __enter__(self):
        if self.traced:
            self.ident = threading.get_ident()
            _CARRIED.add(self.ident)
        return self

    def __exit__(self, *exc):
        if self.traced:
            _CARRIED.discard(self.ident)
        return False


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``; while the calling thread is
    traced, also keep ``(t, name, n)``, so a slice's share can be read."""
    with _LOCK:
        _TOTALS[name] = _TOTALS.get(name, 0) + n
    if tracing():
        _EVENTS.append((time.perf_counter(), name, n))


def count_launches(family: str, steps: int, launches: int, halo: bool = False):
    """Count a kernel wrapper's call: ``kernel.steps.<family>`` and
    ``kernel.launches.<family>`` (the kernels it enqueued), with ``.halo``
    after the family for the halo-in entries of the decomposition."""
    tail = ".halo" if halo else ""
    count(f"kernel.steps.{family}{tail}", steps)
    count(f"kernel.launches.{family}{tail}", launches)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, a blocking read of device data: a ``wait`` span with
    its ``bytes``, counted in ``d2h_bytes``.  A CPU tensor counts alike
    (nothing is copied), so a run counts the same bytes on either device."""
    nbytes = t.numel() * t.element_size()
    with span("wait", bytes=nbytes):
        host = t.cpu()
    count("d2h_bytes", nbytes)
    return host


def spans() -> list:
    """The recorded spans (:class:`Span`), in the order they opened."""
    return list(_SPANS)


def counters() -> dict:
    """Every counter's total since the process started or :func:`reset`."""
    with _LOCK:
        return dict(_TOTALS)


def counter(name: str) -> int:
    """The counter ``name``'s total (0 before its first count)."""
    with _LOCK:
        return _TOTALS.get(name, 0)


def count_events() -> list:
    """The ``(t, name, n)`` of the counts made while traced."""
    return list(_EVENTS)


def reset():
    """Forget the recorded spans (and those an exception left open on the
    calling thread), the counters and their events."""
    _open_spans().clear()
    with _LOCK:
        _SPANS.clear()
        _TOTALS.clear()
        _EVENTS.clear()


def _sync(out):
    """Wait for the device work behind ``out``: a tensor or a tuple of
    tensors (a two-distribution state)."""
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


def _timed(fn, state0, reps):
    """Median wall time of ``reps`` calls of ``fn(state0)``, each ending in a
    device synchronise, their spread (max − min) / median, and the last
    output."""
    dts, out = [], None
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        out = fn(state0)
        _sync(out)
        dts.append(time.perf_counter() - t0)
    dt = float(np.median(dts))
    return dt, float((max(dts) - min(dts)) / dt), out


@dataclasses.dataclass
class Reading:
    """One throughput reading.  ``mlups`` and ``ms_per_step`` are None when
    ``valid`` is False."""
    mlups: Optional[float]
    ms_per_step: Optional[float]
    spread: float
    valid: bool
    out: Any
    overhead_ms: Optional[float] = None


def measure_mlups(step_n_fn, state0, n_steps: int, nelem: int,
                  reps: int = 3) -> Reading:
    """One-shot throughput of ``step_n_fn`` (advances ``n_steps``): one warm
    call, then the median of ``reps`` timed calls on ``state0``."""
    _sync(step_n_fn(state0))
    dt, spread, out = _timed(step_n_fn, state0, reps)
    return Reading(nelem * n_steps / dt / 1e6, dt * 1e3 / n_steps, spread,
                   True, out)


def device_profile(step_n_fn, state0, n_steps: int) -> dict:
    """One call of ``step_n_fn(state0)`` (advancing ``n_steps``) under
    ``torch.profiler`` after a warm call: device time per step by kernel
    name, the device's busy time per step and its idle share of the host
    wall time of the call (which ends in a device synchronise)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(step_n_fn(state0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _sync(step_n_fn(state0))
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        # device-side events only: an aten op's own row repeats the time
        # of the kernels it launched
        if e.device_type == DeviceType.CPU:
            continue
        us = e.self_device_time_total
        if us > 0:
            kernels.append({"name": e.key[:96], "ms_per_step": us / 1e3 / n_steps,
                            "calls_per_step": e.count / n_steps})
    kernels.sort(key=lambda k: -k["ms_per_step"])
    busy = sum(k["ms_per_step"] for k in kernels)
    return {"steps": n_steps, "wall_ms_per_step": wall_ms / n_steps,
            "device_busy_ms_per_step": busy,
            "idle_share": max(0.0, 1.0 - busy * n_steps / wall_ms),
            "kernels": kernels[:12]}


# the device operations of a Chrome trace (those that occupy the card)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(events, top: int = 10) -> dict:
    """The device's idle time in the Chrome trace ``events`` of a driver
    run, named by the program's spans, as :func:`device_profile` reads busy
    and idle: busy is the union of the device operations' intervals.  The
    window runs from the first ``mlbm.kernel.enqueue`` to the end of the
    last ``mlbm.chunk`` on the driver thread (the thread of the
    ``mlbm.chunk`` ranges).  Each gap between busy intervals inside it is
    named by the innermost ``mlbm.*`` range of the driver thread that
    covers the gap's midpoint, ``"-"`` where none does.  Returns
    ``window_s``, ``busy_s``, ``idle_share``, ``idle_s_by_span`` and the
    ``top`` longest gaps as ``[name, seconds, midpoint µs]``; an empty dict
    where the trace holds no chunk or no device operation."""
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and "dur" in e and e.get("name", "").startswith(PREFIX)]
    chunks = [e for e in marks if e["name"] == PREFIX + "chunk"]
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not chunks or not dev:
        return {}
    tid = chunks[0]["tid"]
    mine = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
                  for e in marks if e["tid"] == tid)
    starts = [m[0] for m in mine]
    enq = [m[0] for m in mine if m[2] == "kernel.enqueue"]
    w0 = enq[0] if enq else chunks[0]["ts"]
    w1 = max(e["ts"] + e["dur"] for e in chunks if e["tid"] == tid)

    def innermost(t):
        # ranges of one thread nest, so the covering range that starts
        # last is the innermost
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if mine[i][1] >= t:
                return mine[i][2]
        return "-"

    busy = [[max(a, w0), min(b, w1)] for a, b in _union(dev) if b > w0 and a < w1]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    by, longest = {}, []
    for a, b in gaps:
        name = innermost(0.5 * (a + b))
        by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        longest.append([name, (b - a) * 1e-6, 0.5 * (a + b)])
    longest.sort(key=lambda g: -g[1])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    window_s = (w1 - w0) * 1e-6
    return {"window_s": window_s, "busy_s": busy_s,
            "idle_share": 1.0 - busy_s / window_s if window_s > 0 else 0.0,
            "idle_s_by_span": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "longest": longest[:top]}


def _on_gc(phase, info):
    """A ``gc`` span around each collection of the cyclic garbage
    collector on a traced thread."""
    if phase == "start":
        _LOCAL.gc = span("gc", generation=info["generation"])
        _LOCAL.gc.__enter__()
    elif getattr(_LOCAL, "gc", None) is not None:
        _LOCAL.gc.__exit__(None, None, None)
        _LOCAL.gc = None


def profile_run(fn, path):
    """Run ``fn()`` under ``torch.profiler`` on every thread (CUDA activity
    where a card is visible, Python GC information on) with the recorder
    cleared, and write the Chrome trace to ``path``: the kernels, the
    ``mlbm.*`` spans of every thread on one timeline, ``gc`` spans around
    the garbage collector's runs, and under the key ``mlbm`` the counters
    and :func:`idle_by_span`.  Returns ``fn()``'s result and that
    reduction."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    config = _ExperimentalConfig(profile_all_threads=True,
                                 record_python_gc_info=True)
    reset()
    gc.callbacks.append(_on_gc)
    try:
        # the profiler of every thread leaves the calling thread's flag
        # unset: this thread carries it, and hands it to the writer
        with profile(activities=acts, experimental_config=config) as prof, \
                carry(True):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(_on_gc)
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        trace = json.load(fh)
    summary = idle_by_span(trace.get("traceEvents", []))
    trace["mlbm"] = {"counters": counters(), "idle": summary}
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return out, summary


def measure_mlups_slope(make_step_fn, state0, n1: int, n2: int, nelem: int,
                        reps: int = 3) -> Reading:
    """Two-point slope throughput: cancels the constant per-call cost.

    ``make_step_fn(n)`` returns a function advancing ``n`` steps.  Each of
    the two step counts is warmed once and timed as the median of ``reps``
    calls; ``per_step = (t(n2) − t(n1)) / (n2 − n1)`` and
    ``overhead_ms = t(n1) − per_step · n1``.  ``spread`` is the worse of the
    two medians' spreads; ``out`` is the output of the last ``n2`` call.
    """
    if not (isinstance(n1, int) and isinstance(n2, int) and 0 < n1 < n2):
        raise ValueError(f"slope timing needs 0 < n1 < n2, got n1={n1}, n2={n2}")
    f1, f2 = make_step_fn(n1), make_step_fn(n2)
    for fn in (f1, f2):
        _sync(fn(state0))
    t1, s1, _ = _timed(f1, state0, reps)
    t2, s2, out = _timed(f2, state0, reps)
    per = (t2 - t1) / (n2 - n1)
    spread = max(s1, s2)
    if per <= 0.0:
        return Reading(None, None, spread, False, out)
    return Reading(nelem / per / 1e6, per * 1e3, spread, True, out,
                   overhead_ms=(t1 - per * n1) * 1e3)
