"""Self-test of ``benchmark/program_trace.py`` and the three metrics that
read the program's own spans and counts (``record_exposed_ms``,
``wrapper_us_per_step``, ``d2h_mb_per_record``), on the CPU:

    python3 -m pytest benchmark/tests -q
"""
from __future__ import annotations

import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, program_trace  # noqa: E402

METRICS = ("record_exposed_ms", "wrapper_us_per_step", "d2h_mb_per_record")


def _metric(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def _span(name, t0, t1, thread=1, **attrs):
    return SimpleNamespace(name=name, t0=t0, t1=t1, thread=thread,
                           attrs=attrs, parent=None)


def _run(spans, events, bounds=(10.0, 20.0), family="sc_step"):
    rec = SimpleNamespace(spans=lambda: spans, count_events=lambda: events)
    return SimpleNamespace(recorder=rec, slice_bounds=bounds,
                           spec=SimpleNamespace(config={"work": {"family": family}}))


def test_slice_keeps_what_starts_inside_it():
    spans = [_span("record", 9.9, 10.1), _span("record", 10.0, 10.2),
             _span("wait", 19.9, 20.1), _span("chunk", 20.0, 20.1),
             _span("log", 15.0, None)]
    events = [(9.99, "d2h_bytes", 1), (10.0, "d2h_bytes", 2),
              (19.999, "d2h_bytes", 4), (20.0, "d2h_bytes", 8)]
    got_spans, got_events = program_trace.in_slice(_run(spans, events))
    assert got_spans == [spans[1], spans[2]]
    assert [e[2] for e in got_events] == [2, 4]
    assert program_trace.in_slice(_run(spans, events, bounds=None)) is None


def test_driver_spans_follow_the_loop_thread():
    spans = [_span("vtk.write", 11.0, 12.0, thread=2),
             _span("chunk", 11.5, 11.6, thread=1),
             _span("record", 12.0, 12.1, thread=1),
             _span("record", 13.0, 12.1, thread=2),
             _span("wait", 12.01, 12.02, thread=1)]
    assert program_trace.driver_spans(spans) == [spans[1], spans[2], spans[4]]
    assert program_trace.records(spans) == [spans[2]]
    assert program_trace.driver_spans(spans[:1]) == []


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    import multiphase_lbm_tpu_torch.utils.profiling as prof
    monkeypatch.delattr(prof, "count_events")
    run = SimpleNamespace(slice_bounds=(0.0, 1e9), spec=None)
    assert program_trace.recorder(run) is None
    for name in METRICS:
        assert _metric(name).read(run) is None


def test_metrics_read_synthetic_spans():
    # records at 11 s (last wait ends 11.006, next enqueue 11.012) and
    # 12 s (0.5 ms), one at 13 s with no enqueue after it; one record and
    # its bytes before the slice
    spans = [_span("record", 9.0, 9.01), _span("wait", 9.0, 9.005),
             _span("record", 11.0, 11.01), _span("wait", 11.001, 11.004),
             _span("wait", 11.005, 11.006), _span("chunk", 11.01, 11.02),
             _span("kernel.prepare", 11.011, 11.0116, family="sc_step", steps=100),
             _span("kernel.enqueue", 11.012, 11.0122, family="sc_step", steps=100),
             _span("record", 12.0, 12.001), _span("wait", 12.0, 12.0005),
             _span("chunk", 12.001, 12.002),
             _span("kernel.prepare", 12.0009, 12.001, family="sc_step", steps=60),
             _span("kernel.enqueue", 12.001, 12.0011, family="sc_step", steps=60),
             _span("kernel.enqueue", 12.5, 12.6, family="hcz_step", steps=7),
             _span("record", 13.0, 13.1), _span("wait", 13.0, 13.05)]
    events = [(9.0, "d2h_bytes", 99), (11.002, "d2h_bytes", 4),
              (11.0055, "d2h_bytes", 4), (12.0002, "d2h_bytes", 320016),
              (13.01, "d2h_bytes", 8), (12.4, "kernel.steps.sc_step", 60)]
    run = _run(spans, events)
    assert _metric("record_exposed_ms").read(run) == pytest.approx(3.25)
    # 0.6 + 0.2 + 0.1 + 0.1 ms over 160 steps
    assert _metric("wrapper_us_per_step").read(run) == pytest.approx(6.25)
    assert _metric("d2h_mb_per_record").read(run) == pytest.approx(0.320032 / 3)
    assert _metric("wrapper_us_per_step").read(_run(spans, events, family="x")) is None


def test_d2h_per_record_of_a_driver_run_on_the_cpu(tmp_path):
    """The program's recorder after a traced CPU run of the droplet driver
    (24², float64, a record and a dump every 4 steps): 16 B of scalars and
    four 24² float64 fields a record."""
    from torch.profiler import ProfilerActivity, profile

    from multiphase_lbm_tpu_torch.runners import apps
    from multiphase_lbm_tpu_torch.utils import profiling

    cfg = tmp_path / "case.txt"
    cfg.write_text("N 24\nRR 6\ntau 1.0\nout_freq 4\nvtk_freq 4\n")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        apps.run_sc_laplace2d(str(cfg), str(tmp_path / "o"), max_steps=12,
                              device="cpu")
    s = profiling.spans()
    run = SimpleNamespace(slice_bounds=(s[0].t0, max(x.t1 for x in s) + 1),
                          spec=SimpleNamespace(config={"work": {"family": "sc_step"}}))
    assert _metric("d2h_mb_per_record").read(run) == pytest.approx(
        (16 + 4 * 24 * 24 * 8) / 1e6)
    # the plain path enqueues no kernel
    assert _metric("wrapper_us_per_step").read(run) is None
    assert _metric("record_exposed_ms").read(run) is None
    assert all(x.thread == threading.get_native_id()
               for x in program_trace.driver_spans(s))
