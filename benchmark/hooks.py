"""Spans and captures around the program's entries, from the benchmark's side.

The benchmark reads the program only through the entries its configuration
file names: the stepping entry (the kernel wrapper), the driver's
``Driver`` (its construction), the ``.dat`` logger, the driver's VTK dump
and the VTK writer.  :class:`Hooks` replaces each for
the duration of a ``with`` block by a wrapper that records a span on the
host clock (and, in a traced run, a ``torch.profiler.record_function``
range named ``bench.<span>``), then calls the original.  The window of a
driver call starts when it builds its ``Driver`` (after the lattice's
initial state is made), where the reference's MLUPS clock starts.  The
stepping wrapper also keeps the state that enters the chunks the check
samples and the chunk that ends at the call's ``max_steps``, counts the
steps of every stepping call from that chunk to the end of the call, and
starts and stops the profiler's slice at record boundaries.
"""
from __future__ import annotations

import contextlib
import importlib
import time

SPAN_PREFIX = "bench."


def resolve(target: str):
    """``"pkg.module:Attr.attr"`` → (owner, attribute name, object)."""
    mod_name, _, path = target.partition(":")
    owner, obj = None, importlib.import_module(mod_name)
    for part in path.split("."):
        owner, obj = obj, getattr(obj, part)
    return owner, path.split(".")[-1], obj


class Slice:
    """The profiler's steady slice: it starts at the first record boundary
    at or after ``start_it`` and stops at the first record boundary at
    least ``seconds`` later (or when the window ends)."""

    def __init__(self, start_it: int, seconds: float, every: int):
        self.start_it, self.seconds, self.every = start_it, seconds, every
        self.prof = None
        self.t0 = self.t1 = None
        self.it0 = self.it1 = None

    def at_step(self, it: int):
        if it % self.every:
            return
        if self.prof is None and it >= self.start_it:
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t0, self.it0 = time.perf_counter(), it
        elif self.prof is not None and self.t1 is None and \
                time.perf_counter() - self.t0 >= self.seconds:
            self.stop(it)

    def stop(self, it: int):
        if self.prof is None or self.t1 is not None:
            return
        import torch
        torch.cuda.synchronize()
        self.t1, self.it1 = time.perf_counter(), it
        self.prof.stop()

    @property
    def steps(self):
        return None if self.it1 is None else self.it1 - self.it0


class Hooks:
    """Wrappers around the configuration's entries; see the module note."""

    def __init__(self, config: dict, traced: bool):
        self.config = config
        self.traced = traced
        self._saved = []
        self.new_call()

    def new_call(self, capture_its=(), slice_=None, final_it=None):
        """Reset what one driver call records.  The states entering the
        chunks at ``capture_its`` are kept as copies taken as they enter
        (the program frees its states as it goes), and the state entering
        the chunk that ends at ``final_it`` as it is (the program holds it
        through that chunk, so keeping it raises no peak).  ``last`` is
        ``(it, state, n)``: the steps ``n`` from that state to the one the
        call returns, that chunk's and those of every later stepping call
        of the call (a driver whose loop runs to ``final_it`` inclusive
        takes one more step, through which the kept state is one more than
        the program holds)."""
        self.it = 0
        self.final_it = final_it
        self.spans = []          # (name, t0, t1) on the host clock
        self.records = []        # host time of each record's first file
        self.driver_t = None     # when the call built its Driver
        self.capture_its = set(capture_its)
        self.captured = {}       # it -> state entering the chunk
        self.last = None         # (it, state, n) from the final chunk on
        self.slice = slice_

    @contextlib.contextmanager
    def _span(self, name):
        rf = contextlib.nullcontext()
        if self.traced and self.slice is not None and self.slice.prof is not None:
            import torch
            rf = torch.profiler.record_function(SPAN_PREFIX + name)
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                # list.append is atomic: the writer thread's spans land here too
                self.spans.append((name, t0, time.perf_counter()))

    # ── the wrappers ──
    def _step(self, orig):
        ns = self.config["state_args"]
        steps_arg = self.config["steps_arg"]

        def step(*args, **kw):
            n = int(args[steps_arg] if len(args) > steps_arg else kw["n_steps"])
            if self.slice is not None:
                self.slice.at_step(self.it)
            state = tuple(args[:ns])
            if self.last is not None:
                it, kept, steps = self.last
                self.last = (it, kept, steps + n)
            elif self.it + n == self.final_it:
                self.last = (self.it, state, n)
                if self.it in self.capture_its:
                    self.captured[self.it] = state
            elif self.it in self.capture_its:
                self.captured[self.it] = tuple(t.clone() for t in state)
            with self._span("step"):
                out = orig(*args, **kw)
            self.it += n
            return out
        return step

    def _log(self, orig):
        first = self.config["record_file"]

        def log(logger, *args, **kw):
            if logger.path.name == first:
                self.records.append(time.perf_counter())
            with self._span("log"):
                return orig(logger, *args, **kw)
        return log

    def _named(self, orig, name):
        def wrapped(*args, **kw):
            with self._span(name):
                return orig(*args, **kw)
        return wrapped

    def _start(self, orig):
        def init(*args, **kw):
            self.driver_t = time.perf_counter()
            return orig(*args, **kw)
        return init

    def __enter__(self):
        hooks = self.config["hooks"]
        plan = [(self.config["stepping"], self._step),
                (hooks["window_start"], self._start),
                (hooks["record"], self._log),
                (hooks["vtk"], lambda o: self._named(o, "vtk")),
                (hooks["vtk_write"], lambda o: self._named(o, "vtk_write"))]
        for target, make in plan:
            owner, attr, orig = resolve(target)
            self._saved.append((owner, attr, orig))
            setattr(owner, attr, make(orig))
        return self

    def __exit__(self, *exc):
        while self._saved:
            owner, attr, orig = self._saved.pop()
            setattr(owner, attr, orig)
        return False
