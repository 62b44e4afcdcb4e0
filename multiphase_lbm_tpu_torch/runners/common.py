"""Shared driver plumbing: output cadence, VTK/dat emission, MLUPS report.

Port of ``multiphase_lbm_tpu/runners/common.py``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..io.loggers import DatLogger, MlupsClock
from ..io.vtk import VtkWriter, sol_filename
from ..utils.profiling import carry, count, phase, span, to_host, tracing


class _HostCopies:
    """The fields of one dump on their way to the host, in the groups
    ``write_vtk`` takes.  Each CUDA tensor is copied into pinned memory with
    ``non_blocking=True`` on the current stream, and one event is recorded
    after the last copy; :meth:`groups` waits on that event once, so the
    writer thread gives up the interpreter lock for one wait a dump, not
    one a field.  Later work on the stream cannot overwrite a source before
    its copy has run, because the copy is ordered before it.  A tensor's
    bytes count in ``d2h_bytes`` on either device, as
    :func:`..utils.profiling.to_host` counts them."""

    def __init__(self, *groups):
        self._copied = False
        self._groups = tuple(tuple((name, self._stage(data))
                                   for name, data in fields)
                             for fields in groups)
        self._event = None
        if self._copied:
            self._event = torch.cuda.Event()
            self._event.record()

    def _stage(self, data):
        if not isinstance(data, torch.Tensor):
            return np.asarray(data)
        count("d2h_bytes", data.numel() * data.element_size())
        if not data.is_cuda:
            return data.detach()
        host = torch.empty(data.shape, dtype=data.dtype, pin_memory=True)
        host.copy_(data, non_blocking=True)
        self._copied = True
        return host

    def groups(self):
        """Each group's ``(name, numpy array)`` pairs, once the copies ran."""
        if self._event is not None:
            self._event.synchronize()
        return tuple(tuple((name, d.numpy() if isinstance(d, torch.Tensor)
                            else d) for name, d in fields)
                     for fields in self._groups)


class Driver:
    """Replicates the reference drivers' loop skeleton: periodic VTK dumps,
    periodic stdout + .dat logging, end-of-run MLUPS line (e.g.
    laplace2D.h:485-511).

    VTK dumps are ASYNCHRONOUS by default (``async_io=True``): each field's
    device→host copy starts at once (pinned memory, non-blocking), then
    formatting and the disk write run on a single worker thread, which
    waits once for the dump's copies (:class:`_HostCopies`), while the main
    thread enqueues the next chunk of steps.  In-flight dumps are bounded
    to 2 so a run cannot accumulate host staging.  ``finish()`` drains the
    queue and re-raises the first worker error, so files are complete (and
    failures loud) before the MLUPS line prints.  The model functions return new tensors and never
    write into their inputs, so a snapshot handed to the worker cannot be
    changed by later steps.  Output is byte-identical to synchronous
    writes (``async_io=False``).

    A ``driver`` phase (``utils/profiling.phase``: recorded with or without
    the profiler) runs from the construction until :meth:`finish` has
    drained the dumps.  While ``torch.profiler`` records, the loops of
    ``runners/apps.py`` mark each iteration with the spans of
    :meth:`record`, :meth:`dump` and :meth:`chunk` inside it, their
    blocking reads of device data with :meth:`scalar` and :meth:`numpy`
    (``wait``), and the writer thread records ``vtk.write`` for each dump
    it formats and writes."""

    def __init__(self, outdir, nelem, out_freq=0, vtk_freq=0,
                 async_io=True):
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.out_freq = out_freq
        self.vtk_freq = vtk_freq
        self.clock = MlupsClock(nelem)
        self._logs = {}
        self.async_io = async_io
        self._pool = None
        self._writes = []
        self._io_err = None
        # the driver call's phase, from here until finish() has drained the
        # dumps: the loop's own code between its record, dump and chunk spans
        self._span = phase("driver")
        self._span.__enter__()

    def log_file(self, name) -> DatLogger:
        if name not in self._logs:
            self._logs[name] = DatLogger(self.outdir / name)
        return self._logs[name]

    def want_vtk(self, it) -> bool:
        return self.vtk_freq != 0 and it % self.vtk_freq == 0

    def want_out(self, it) -> bool:
        return self.out_freq != 0 and it % self.out_freq == 0

    # the loop's spans: record around the diagnostics of a record, dump
    # around a dump (its field kernels included), chunk around the rest of
    # an iteration (next_chunk, the stepping entry, clock.tick)
    @staticmethod
    def record(it):
        return span("record", it=it)

    @staticmethod
    def dump(it):
        return span("dump", it=it)

    @staticmethod
    def chunk(it):
        return span("chunk", it=it)

    @staticmethod
    def scalar(t) -> float:
        """``float(t)`` of a one-element tensor, read as a ``wait``."""
        return float(to_host(t))

    @staticmethod
    def numpy(t) -> np.ndarray:
        """``t`` as a host numpy array, read as a ``wait``."""
        return to_host(t).numpy()

    def write_vtk(self, it, nx, ny, nz=1, spacing=1.0, scalars=(), vectors=(),
                  int_scalars=()):
        if not self.async_io:
            self._do_write(it, nx, ny, nz, spacing,
                           _HostCopies(scalars, vectors, int_scalars))
            return
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="vtk-io")
        # enforce the in-flight bound BEFORE staging this dump's copies, so
        # at most 2 snapshots are ever held (executing + queued)
        with span("vtk.inflight"):
            while len(self._writes) >= 2:
                try:
                    self._writes.pop(0).result()
                except Exception as e:
                    # defer to drain()/finish(): raising from inside the
                    # time loop would leave the remaining queued future and
                    # the pool undrained
                    if self._io_err is None:
                        self._io_err = e
        # the writer thread records its spans when this thread is traced
        self._writes.append(self._pool.submit(
            self._do_write, it, nx, ny, nz, spacing,
            _HostCopies(scalars, vectors, int_scalars), tracing()))

    def _do_write(self, it, nx, ny, nz, spacing, staged, traced=False):
        with carry(traced), span("vtk.write", it=it):
            w = VtkWriter(nx, ny, nz, spacing=spacing, iteration=it)
            scalars, vectors, int_scalars = staged.groups()
            for name, data in scalars:
                w.scalar(name, data)
            for name, data in vectors:
                w.vector(name, data)
            for name, data in int_scalars:
                w.scalar(name, data, as_int=True)
            w.write(self.outdir / sol_filename(it))

    def drain(self):
        """Block until ALL queued dumps are on disk; then re-raise the
        first worker error (every future is awaited before raising)."""
        writes, self._writes = self._writes, []
        first_err, self._io_err = self._io_err, None
        for fut in writes:
            try:
                fut.result()
            except Exception as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def finish(self):
        # even on a failed dump, release the worker thread and flush/close
        # the .dat logs before propagating
        try:
            self.drain()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
            for lg in self._logs.values():
                lg.close()
            self._span.__exit__(None, None, None)
        print(self.clock.report())
        return self.clock.mlups


def next_chunk(it, steps, *freqs):
    """Steps to advance from ``it`` so the loop lands exactly on the next
    diagnostic event: the smallest distance to a multiple of any nonzero
    cadence, bounded by the end of the run."""
    dists = [f - it % f for f in freqs if f]
    return max(1, min([steps - it] + dists))
