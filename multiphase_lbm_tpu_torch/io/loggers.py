"""Flat ``.dat`` time-series loggers + MLUPS reporter, reference-compatible.

Covers the reference's observability surface (SURVEY §5.5): ``energy.dat``,
``mass.dat``, ``contact_angle.dat``, ``spike_bubble_position.dat``,
``spike_bubble_velocity.dat``, ``density_probe.dat`` and the end-of-run MLUPS
line (``printMlups_*``, e.g. laplace2D.h:79-86: MLUPS = nelem·iters/µs).
"""
from __future__ import annotations

import time
from pathlib import Path

from ..utils.profiling import span


class DatLogger:
    """Append whitespace-separated columns to a .dat file."""

    def __init__(self, path, mode: str = "w"):
        self.path = Path(path)
        self._fh = open(self.path, mode)

    def log(self, *cols, fmt: str = "%.16g"):
        with span("log"):
            self._fh.write(" ".join(
                fmt % c if isinstance(c, float) else str(c) for c in cols)
                + "\n")
            self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MlupsClock:
    """Wall-clock → MLUPS with the reference's exact definition
    (``printMlups``: nelem · iterations / microseconds)."""

    def __init__(self, nelem: int):
        self.nelem = nelem
        self.restart()

    def restart(self):
        self.t0 = time.perf_counter()
        self.iters = 0

    def tick(self, n: int = 1):
        self.iters += n

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def mlups(self) -> float:
        us = self.seconds * 1e6
        return (self.nelem * self.iters) / us if us > 0 else 0.0

    def report(self) -> str:
        return (f"Runtime: {self.seconds:.6g} s\n"
                f"Throughput: {self.mlups:.5g} MLUPS")
