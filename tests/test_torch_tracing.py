"""The port's own spans and counters (``utils/profiling``): the recorder,
the set-up phases, the driver loop's spans and bytes read to the host, the
kernel wrappers' launch counters, the 3D droplet's, the Fakhari bubble's
and the SC-RT channel's ``record.energy`` spans and the SC-RT
``record.interface`` span, the operator's ``--profile`` exporter and the
benchmark's per-layer metrics that read them.

The CPU tests run the plain path, which enqueues no kernel, so the
``kernel.*`` spans and launch counters are checked by the ``gpu`` tests
at the end, which skip without a card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_tracing.py
"""
import importlib
import importlib.util
import json
import re
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multiphase_lbm_tpu_torch.runners import apps, coolbm
from multiphase_lbm_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


def _names(spans):
    return [s.name for s in spans]


def test_span_without_profiler_records_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset()
    assert not profiling.tracing()
    with profiling.span("outer", it=3):
        with profiling.span("inner"):
            profiling.count("things", 3)
    profiling.count("things", 2)
    assert profiling.spans() == [] and profiling.count_events() == []
    assert profiling.counters() == {"things": 5}
    assert profiling.counter("things") == 5 and profiling.counter("none") == 0


def test_phase_records_without_profiler(monkeypatch, tmp_path):
    """A phase records with no profiler and opens no ``record_function``
    then (a span beside it records nothing); under the profiler it lands
    on the Chrome trace as ``mlbm.<name>``.  ``upload`` copies inside an
    ``init.upload`` phase with its bytes; ``device_context`` does nothing
    on the CPU."""
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset()
    a = np.arange(6.0).reshape(2, 3)
    with profiling.phase("init", driver="d") as init:
        profiling.device_context("cpu")
        with profiling.span("record"):
            t = profiling.upload(a, "cpu")
    up, = [s for s in profiling.spans() if s is not init]
    assert profiling.spans() == [init, up]
    assert init.attrs == {"driver": "d"} and init.parent is None
    assert up.name == "init.upload" and up.attrs == {"bytes": 48} and up.parent is init
    assert init.t0 <= up.t0 <= up.t1 <= init.t1
    assert up.thread == init.thread == threading.get_native_id()
    assert torch.equal(t, torch.from_numpy(a))
    monkeypatch.undo()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.phase("library.load", lib="kernels"):
            pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert [e["name"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("name", "").startswith("mlbm.")] == ["mlbm.library.load"]
    assert [s.name for s in profiling.spans()] == ["library.load"]


def _phase_cases():
    """The drivers the benchmark calls, at tiny lattices in float64 on the
    CPU: (driver, case file, steps, cells, bytes its initial state
    uploads)."""
    return [
        (apps.run_sc_laplace2d, "N 16\nRR 5\ntau 1.0\nout_freq 4\nvtk_freq 0\n",
         8, 16 * 16, 9 * 16 * 16 * 8),
        (apps.run_rayleigh_taylor_pf, "N 8\nRe 20\nout_freq 4\nvtk_freq 0\n",
         8, 8 * 34, 2 * 9 * 8 * 34 * 8),
        (apps.run_laplace3d, "N 8\nRe 0.9\nout_freq 4\nvtk_freq 0\n",
         4, 8 ** 3, 2 * 19 * 8 ** 3 * 8),
        (apps.run_young_laplace2d, "N 16\nout_freq 4\nvtk_freq 0\n",
         8, 16 * 16, 2 * 9 * 16 * 16 * 8),
        (apps.run_rayleigh_taylor_sc, "N 8\nRe 3.84\nout_freq 4\nvtk_freq 0\n",
         8, 8 * 34, 9 * 8 * 34 * 8)]


@pytest.mark.parametrize("case", _phase_cases(),
                         ids=lambda c: c[0].__name__)
def test_driver_call_records_init_then_driver(case, tmp_path):
    """With no profiler, a driver call records one ``init`` phase (its
    name and cells) holding every ``init.upload`` of its initial state,
    then one ``driver`` phase; nothing else records on the CPU."""
    torch.set_num_threads(1)
    driver, text, steps, cells, nbytes = case
    cfg = tmp_path / "case.txt"
    cfg.write_text(text)
    profiling.reset()
    driver(str(cfg), str(tmp_path / "out"), max_steps=steps, device="cpu")
    spans = profiling.spans()
    main = threading.get_native_id()
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ["init", "driver"]
    init, drv = top
    assert all(s.thread == main for s in spans)
    assert init.attrs == {"driver": driver.__name__, "cells": cells}
    assert init.t1 <= drv.t0 and drv.t1 is not None
    uploads = [s for s in spans if s.name == "init.upload"]
    assert uploads and all(s.parent is init for s in uploads)
    assert sum(s.attrs["bytes"] for s in uploads) == nbytes
    assert len(spans) == 2 + len(uploads)


def test_spans_nest_and_reach_the_chrome_trace(tmp_path):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer", it=7):
            with profiling.span("inner", bytes=8):
                profiling.count("d2h_bytes", 8)
            with profiling.span("inner"):
                pass
    outer, a, b = profiling.spans()
    assert _names([outer, a, b]) == ["outer", "inner", "inner"]
    assert outer.parent is None and a.parent is outer and b.parent is outer
    assert outer.attrs == {"it": 7} and a.attrs == {"bytes": 8}
    assert outer.t0 <= a.t0 <= a.t1 <= b.t0 <= b.t1 <= outer.t1
    assert a.thread == outer.thread == threading.get_native_id()
    (t, name, n), = profiling.count_events()
    assert name == "d2h_bytes" and n == 8 and a.t0 <= t <= a.t1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    marks = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("name", "").startswith("mlbm.")]
    assert sorted(e["name"] for e in marks) == ["mlbm.inner", "mlbm.inner",
                                                 "mlbm.outer"]
    assert {e["tid"] for e in marks} == {outer.thread}


def test_worker_thread_records_only_what_it_carries():
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = profiling.tracing()

        def work(flag):
            with profiling.carry(flag), profiling.span("vtk.write", flag=flag):
                profiling.count("w", 1)
        for flag in (traced, False):
            t = threading.Thread(target=work, args=(flag,))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    s, = profiling.spans()
    assert traced and s.name == "vtk.write" and s.attrs == {"flag": True}
    assert s.thread != threading.get_native_id() and s.parent is None
    assert len(profiling.count_events()) == 1 and profiling.counter("w") == 2


def _sc_case(tmp_path):
    cfg = tmp_path / "sc.txt"
    cfg.write_text("N 24\nRR 6\ntau 1.0\nout_freq 4\nvtk_freq 4\n")
    n = 24 * 24
    # each record reads energy and mass (float64 scalars); each dump stages
    # Density, Pressure and the two components of Force
    reads = {"record": 2 * 8, "dump": 4 * n * 8}
    return apps.run_sc_laplace2d, cfg, 12, reads, 0


def _rti_case(tmp_path):
    cfg = tmp_path / "rti.txt"
    cfg.write_text("N 16\nRe 20\nout_freq 4\nvtk_freq 8\n")
    n = 16 * (4 * 16 + 2)
    # each record reads its energy and the spike and bubble heights, three
    # float64 in one read (hcz_fused.record_2d); each dump stages φ and the
    # density (the Flag field is host data); the Flag is read once, as a
    # bool mask, before the loop
    reads = {"record": 3 * 8, "dump": 2 * n * 8}
    return apps.run_rayleigh_taylor_pf, cfg, 16, reads, n


@pytest.mark.parametrize("case", [_sc_case, _rti_case],
                         ids=["run_sc_laplace2d", "run_rayleigh_taylor_pf"])
def test_driver_loop_spans_and_bytes_read(case, tmp_path):
    torch.set_num_threads(1)
    driver, cfg, steps, reads, setup_bytes = case(tmp_path)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        driver(str(cfg), str(tmp_path / "out"), max_steps=steps, device="cpu")
    spans = profiling.spans()
    main = threading.get_native_id()
    init_span, driver_span = [s for s in spans if s.thread == main and s.parent is None]
    assert init_span.name == "init" and init_span.t1 <= driver_span.t0
    assert driver_span.name == "driver" and driver_span.t1 is not None
    top = [s for s in spans if s.parent is driver_span]
    # the RTI driver reads its Flag mask once, before the loop
    setup = [s for s in top if s.name == "wait"]
    assert [s.attrs["bytes"] for s in setup] == ([setup_bytes] if setup_bytes else [])
    top = [s for s in top if s not in setup]
    out_freq, vtk_freq = 4, (4 if driver is apps.run_sc_laplace2d else 8)
    want = []
    for it in range(0, steps, out_freq):
        want += (["dump"] if it % vtk_freq == 0 else []) + ["record", "chunk"]
    assert _names(top) == want
    assert [s.attrs["it"] for s in top] == [
        it for it in range(0, steps, out_freq)
        for _ in range(2 + (it % vtk_freq == 0))]
    for s in spans:
        if s.name in ("wait", "log") and s not in setup:
            assert s.parent is not None and s.parent.name == "record", s
        if s.name == "vtk.inflight":
            assert s.parent.name == "dump"
        if s.name in ("vtk.format", "vtk.disk"):
            assert s.parent.name == "vtk.write" and s.thread != main
    assert not any(s.name.startswith("kernel.") for s in spans)
    writes = [s for s in spans if s.name == "vtk.write"]
    assert len(writes) == want.count("dump") and all(s.thread != main for s in writes)
    n_rec, n_dump = want.count("record"), want.count("dump")
    total = n_rec * reads["record"] + n_dump * reads["dump"] + setup_bytes
    assert profiling.counter("d2h_bytes") == total
    waits = [s for s in spans if s.name == "wait" and s not in setup]
    assert sum(s.attrs["bytes"] for s in waits) == n_rec * reads["record"]


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_laplace3d_record_energy_span_and_counter(device, tmp_path, request):
    """A traced ``run_laplace3d``: one ``record.energy`` span a record,
    inside the record, with its read; ``kernel.steps.hcz3d_record`` counts
    one a record on the card and none on the CPU (the plain path), and the
    wrapper counts two ``hcz3d_step`` launches a step on the card."""
    if device == "cuda":
        request.getfixturevalue("cuda_device")
    torch.set_num_threads(1)
    cfg = tmp_path / "l3.txt"
    cfg.write_text("N 12\nRe 0.9\nout_freq 4\nvtk_freq 0\n")
    run = lambda: apps.run_laplace3d(  # noqa: E731
        str(cfg), str(tmp_path / "out"), dtype=torch.float32, max_steps=10,
        device=device)
    run()                                   # on the card: builds the library
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    spans = profiling.spans()
    records = [s for s in spans if s.name == "record"]
    energy = [s for s in spans if s.name == "record.energy"]
    assert [s.attrs["it"] for s in records] == [0, 4, 8]
    assert [s.parent for s in energy] == records
    assert all(s.attrs == {"family": "hcz3d"} for s in energy)
    assert all(any(w.name == "wait" and w.parent is s for w in spans)
               for s in energy)
    assert len(records) == 3
    assert profiling.counter("kernel.steps.hcz3d_record") == (
        len(records) if device == "cuda" else 0)
    launches = profiling.counter("kernel.launches.hcz3d_step")
    assert launches == (2 * 10 if device == "cuda" else 0)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_young_laplace2d_record_energy_span_and_counter(device, tmp_path, request):
    """A traced ``run_young_laplace2d``: one ``record.energy`` span a record
    (``family="fakhari"``), inside the record, holding both reads (energy
    and mass).  Its loop runs to ``max_steps`` inclusive: 10 steps in
    chunks of 4, 4 and 2, then one more step, four calls; on the card the
    wrapper counts one ``fakhari_step`` launch a step and one velocity pass
    a call, and none on the CPU (the plain path)."""
    if device == "cuda":
        request.getfixturevalue("cuda_device")
    torch.set_num_threads(1)
    cfg = tmp_path / "yl.txt"
    cfg.write_text("N 16\nout_freq 4\nvtk_freq 0\n")
    run = lambda: apps.run_young_laplace2d(  # noqa: E731
        str(cfg), str(tmp_path / "out"), dtype=torch.float32, max_steps=10,
        device=device)
    run()                                   # on the card: builds the library
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    spans = profiling.spans()
    records = [s for s in spans if s.name == "record"]
    energy = [s for s in spans if s.name == "record.energy"]
    assert [s.attrs["it"] for s in records] == [0, 4, 8]
    assert [s.parent for s in energy] == records
    assert all(s.attrs == {"family": "fakhari"} for s in energy)
    assert all(len([w for w in spans if w.name == "wait" and w.parent is s]) == 2
               for s in energy)
    assert profiling.counter("kernel.steps.fakhari_step") == (
        11 if device == "cuda" else 0)
    assert profiling.counter("kernel.launches.fakhari_step") == (
        1 * 11 + 4 if device == "cuda" else 0)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_rayleigh_taylor_sc_record_spans_and_counter(device, tmp_path, request):
    """A traced ``run_rayleigh_taylor_sc`` at 16 × 66 float32: inside each
    record one ``record.energy`` span (``family="scrt"``) holding the one
    read of the record's four doubles (energy, mass and the two rows: a
    ``wait`` of 32 bytes), then one ``record.interface`` span, which takes
    the rows from that host copy and reads nothing more.  10 steps in
    chunks of 4, 4 and 2; on the card the wrappers count two
    ``scrt_step`` launches a step (the ψ pass and the collide-and-stream)
    and two ``scrt_record`` launches a record (the ψ pass and the record
    pass), and none of either on the CPU (the plain path)."""
    if device == "cuda":
        request.getfixturevalue("cuda_device")
    torch.set_num_threads(1)
    cfg = tmp_path / "rt.txt"
    cfg.write_text("N 16\nRe 3.84\nout_freq 4\nvtk_freq 0\n")
    run = lambda: apps.run_rayleigh_taylor_sc(  # noqa: E731
        str(cfg), str(tmp_path / "out"), dtype=torch.float32, max_steps=10,
        device=device)
    run()                                   # on the card: builds the library
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    spans = profiling.spans()
    records = [s for s in spans if s.name == "record"]
    energy = [s for s in spans if s.name == "record.energy"]
    interface = [s for s in spans if s.name == "record.interface"]
    assert [s.attrs["it"] for s in records] == [0, 4, 8]
    assert [s.parent for s in energy] == records == [s.parent for s in interface]
    assert all(s.attrs == {"family": "scrt"} for s in energy)
    assert all(e.t1 <= i.t0 for e, i in zip(energy, interface))

    def waits(parent):
        return [w.attrs["bytes"] for w in spans if w.name == "wait" and w.parent is parent]
    assert all(waits(s) == [32] for s in energy)
    assert all(waits(s) == [] for s in interface)
    steps = profiling.counter("kernel.steps.scrt_step")
    assert steps == (10 if device == "cuda" else 0)
    assert profiling.counter("kernel.launches.scrt_step") == 2 * steps
    recs = profiling.counter("kernel.steps.scrt_record")
    assert recs == (len(records) if device == "cuda" else 0)
    assert profiling.counter("kernel.launches.scrt_record") == 2 * recs


def test_profile_flag_writes_both_threads_spans_and_counters(tmp_path, capsys):
    torch.set_num_threads(1)
    cfg = tmp_path / "sc.txt"
    cfg.write_text("N 16\nRR 5\ntau 1.0\nout_freq 4\nvtk_freq 4\n")
    path = tmp_path / "trace.json"
    assert coolbm.main(["laplace2D_sc", "--device", "cpu", "--config", str(cfg),
                        "--steps", "8", "--outdir", str(tmp_path / "o"),
                        "--profile", str(path)]) == 0
    trace = json.loads(path.read_text())
    marks = [e for e in trace["traceEvents"] if e.get("name", "").startswith("mlbm.")]
    by_tid = {}
    for e in marks:
        by_tid.setdefault(e["tid"], set()).add(e["name"])
    assert len(by_tid) == 2
    assert {"mlbm.record", "mlbm.dump", "mlbm.chunk", "mlbm.wait",
            "mlbm.log"} <= set().union(*by_tid.values())
    assert any({"mlbm.vtk.write", "mlbm.vtk.format", "mlbm.vtk.disk"} <= names
               for names in by_tid.values())
    assert trace["mlbm"]["counters"]["d2h_bytes"] == 2 * (16 + 4 * 16 * 16 * 8)
    assert {"mlbm.init", "mlbm.init.upload", "mlbm.driver"} <= by_tid[
        next(e["tid"] for e in marks if e["name"] == "mlbm.chunk")]
    out = capsys.readouterr().out
    assert "profile: trace written to" in out
    assert "profile:   init 1 " in out and "profile:   driver 1 " in out
    assert "profile:   init.upload 1 " in out


def test_idle_by_span_names_gaps_by_the_innermost_driver_span():
    def x(name, ts, dur, tid=1, cat="user_annotation"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "pid": 1}
    ev = [x("mlbm.chunk", 0, 20), x("mlbm.kernel.prepare", 2, 3),
          x("mlbm.kernel.enqueue", 10, 2),
          x("mlbm.record", 20, 40), x("mlbm.wait", 22, 10), x("mlbm.log", 40, 5),
          x("mlbm.chunk", 60, 30), x("mlbm.kernel.enqueue", 80, 2),
          x("mlbm.vtk.write", 0, 90, tid=2),
          x("mlbm.chunk", 36, 50, tid=7, cat="gpu_user_annotation"),
          x("k", 11, 20, cat="kernel"), x("copy", 32, 4, cat="gpu_memcpy"),
          x("k", 81, 30, cat="kernel")]
    r = profiling.idle_by_span(ev)
    # window 10 .. 90 µs; busy 11-31, 32-36, 81-90
    assert r["window_s"] == pytest.approx(80e-6)
    assert r["busy_s"] == pytest.approx(33e-6)
    assert r["idle_share"] == pytest.approx(1 - 33 / 80)
    # gaps: 10-11 (enqueue), 31-32 (wait), 36-81 (mid 58.5: record)
    assert r["idle_s_by_span"] == pytest.approx(
        {"record": 45e-6, "kernel.enqueue": 1e-6, "wait": 1e-6})
    assert r["longest"][0][:2] == ["record", pytest.approx(45e-6)]
    assert profiling.idle_by_span([x("k", 0, 1, cat="kernel")]) == {}


def _metric(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic_run():
    """A traced slice from 10 s to 20 s of the driver's thread 1: records at
    11 s (waits ending 11.006 s, next enqueue 11.012 s), 12 s (2 ms
    exposed) and 13 s (no enqueue after it), one before and one after the
    slice; ``record.interface`` spans of 3 ms and 0.3 ms in the records at
    11 s and 12 s, and one of 6 ms after the slice; 800 sc_step steps in
    1.2 ms of wrapper spans, an hcz_step call that is not the cell's
    family, and d2h_bytes of 67,125,264 B in it."""
    def s(name, t0, t1, thread=1, **attrs):
        return SimpleNamespace(name=name, t0=t0, t1=t1, thread=thread,
                               attrs=attrs, parent=None)
    spans = [
        s("record", 9.0, 9.01), s("wait", 9.001, 9.002),
        s("kernel.enqueue", 9.02, 9.03, family="sc_step", steps=400),
        s("record", 11.0, 11.010), s("wait", 11.001, 11.004),
        s("wait", 11.005, 11.006), s("record.interface", 11.0061, 11.0091),
        s("log", 11.0092, 11.0095),
        s("chunk", 11.010, 11.020),
        s("kernel.prepare", 11.011, 11.0115, family="sc_step", steps=400),
        s("kernel.enqueue", 11.012, 11.0121, family="sc_step", steps=400),
        s("vtk.write", 11.5, 11.9, thread=2),
        s("record", 12.0, 12.0025), s("wait", 12.001, 12.002),
        s("record.interface", 12.0021, 12.0024),
        s("chunk", 12.0025, 12.006),
        s("kernel.prepare", 12.003, 12.0035, family="sc_step", steps=400),
        s("kernel.enqueue", 12.004, 12.0041, family="sc_step", steps=400),
        s("kernel.enqueue", 12.5, 12.6, family="hcz_step", steps=9),
        s("record", 13.0, 13.002), s("wait", 13.0, 13.001),
        s("record", 25.0, 25.01), s("wait", 25.001, 25.002),
        s("record.interface", 25.003, 25.009),
        s("kernel.enqueue", 25.02, 25.03, family="sc_step", steps=400)]
    events = [(9.5, "d2h_bytes", 1000), (11.002, "d2h_bytes", 4),
              (11.0055, "d2h_bytes", 4), (11.5, "kernel.steps.sc_step", 400),
              (12.0015, "d2h_bytes", 67125248), (13.0005, "d2h_bytes", 8),
              (25.0015, "d2h_bytes", 1000)]
    recorder = SimpleNamespace(spans=lambda: spans, count_events=lambda: events)
    spec = SimpleNamespace(config={"work": {"family": "sc_step"}})
    return SimpleNamespace(recorder=recorder, slice_bounds=(10.0, 20.0),
                           spec=spec)


@pytest.mark.parametrize("name,value", [
    ("record_exposed_ms", 4.0), ("wrapper_us_per_step", 1.5),
    ("d2h_mb_per_record", 67.125264 / 3), ("record_interface_ms", 1.65)])
def test_metric_reads_a_synthetic_recorder(name, value):
    metric = _metric(name)
    assert metric.read(_synthetic_run()) == pytest.approx(value, rel=1e-9)
    assert metric.read(SimpleNamespace(**dict(vars(_synthetic_run()),
                                              slice_bounds=None))) is None


def test_record_device_ms_reads_kernels_outside_step_per_energy_span():
    """The kernels launched outside the benchmark's ``step`` span, over the
    ``record.energy`` spans that start in the slice (10 s to 20 s: two of
    the three); nothing where the program records no such span."""
    def s(name, t0, t1):
        return SimpleNamespace(name=name, t0=t0, t1=t1, thread=1, attrs={},
                               parent=None)
    spans = [s("record", 11.0, 11.01), s("record.energy", 11.001, 11.009),
             s("chunk", 11.01, 11.5), s("record", 12.0, 12.01),
             s("record.energy", 12.001, 12.009), s("record", 25.0, 25.01),
             s("record.energy", 25.001, 25.009)]
    recorder = SimpleNamespace(spans=lambda: spans, count_events=lambda: [])
    sliced = {"span_kernel_s": {"step": 0.66, "diagnostics": 0.03, "log": 0.002}}
    run = SimpleNamespace(recorder=recorder, slice_bounds=(10.0, 20.0),
                          slice=sliced)
    metric = _metric("record_device_ms")
    assert metric.read(run) == pytest.approx(16.0, rel=1e-12)
    older = SimpleNamespace(spans=lambda: [x for x in spans if x.name != "record.energy"],
                            count_events=lambda: [])
    assert metric.read(SimpleNamespace(**dict(vars(run), recorder=older))) is None
    assert metric.read(SimpleNamespace(**dict(vars(run), slice=None,
                                              slice_bounds=None))) is None


def test_roofline_of_the_3d_kernel_reads_its_bound():
    """B5's share of its bound at 256³ float32: 304 B a cell over 3.35 TB/s
    is 1.5224 ms a step, so 100 steps in 0.33 s of ``step`` kernels read
    46.13%; another family's cell reads nothing."""
    bench_harness = importlib.import_module("benchmark.harness")
    spec = bench_harness.Spec(ROOT, "hcz_droplet3d.n256.out100")
    run = SimpleNamespace(spec=spec, dtype="float32", nelem=256 ** 3,
                          slice={"span_kernel_s": {"step": 0.33}, "steps": 100})
    bound = 256 ** 3 * 304 / 3.35e12
    assert _metric("roofline_pct.hcz3d_step").read(run) == pytest.approx(
        100.0 * bound * 100 / 0.33, rel=1e-12)
    assert _metric("roofline_pct.hcz_step").read(run) is None


def test_record_interface_ms_reads_nothing_without_the_span():
    """A program that records no ``record.interface`` span (one that
    predates it) gives no reading, and raises nothing."""
    run = _synthetic_run()
    spans = [x for x in run.recorder.spans() if x.name != "record.interface"]
    older = SimpleNamespace(spans=lambda: spans, count_events=run.recorder.count_events)
    assert _metric("record_interface_ms").read(
        SimpleNamespace(**dict(vars(run), recorder=older))) is None


def _phased_run():
    """A benchmark process's phases from T_START = 0 s: the rehearsal call
    (its ``init`` holding the card's context and an upload; its ``driver``
    holding the library's load, nvcc inside it, and the first C call; the
    VTK formatter's load on the writer thread), the warm-up call, then the
    timed call, whose ``driver`` holds the slice (15 s to 17 s) and one
    more first call; ``setup_s`` 9 s."""
    def s(name, t0, t1, thread=1, parent=None, **attrs):
        return SimpleNamespace(name=name, t0=t0, t1=t1, thread=thread,
                               attrs=attrs, parent=parent)
    init0 = s("init", 1.0, 1.5, driver="run_sc_laplace2d")
    drv0 = s("driver", 1.6, 3.0)
    load = s("library.load", 1.7, 2.2, parent=drv0, lib="kernels")
    init1 = s("init", 4.0, 4.8)
    drv1 = s("driver", 5.0, 7.0)
    init2 = s("init", 8.0, 8.6)
    drv2 = s("driver", 9.0, 30.0)
    spans = [
        init0, s("device.context", 1.0, 1.4, parent=init0),
        s("init.upload", 1.4, 1.45, parent=init0, bytes=8), drv0, load,
        s("library.build", 1.8, 2.0, parent=load, lib="kernels"),
        s("kernel.first", 2.3, 2.4, parent=drv0, entry="sc_step_f64"),
        s("library.load", 2.5, 2.6, thread=2, lib="vtkfmt"),
        init1, s("init.upload", 4.5, 4.7, parent=init1, bytes=8), drv1,
        s("kernel.first", 5.1, 5.15, parent=drv1, entry="sc_step_f32"),
        s("record", 6.0, 6.1), init2, drv2,
        s("record", 15.0, 15.1, parent=drv2),
        s("kernel.first", 16.0, 16.01, parent=drv2, entry="hcz_step_f32"),
        s("init", 31.0, None)]
    recorder = SimpleNamespace(spans=lambda: spans, count_events=lambda: [])
    return SimpleNamespace(recorder=recorder, slice_bounds=(15.0, 17.0),
                           setup_s=9.0)


@pytest.mark.parametrize("name,value", [
    # the timed call's init, 8.0 to 8.6 s
    ("init_state_s", 0.6),
    # context 0.4, kernel library 0.5 less nvcc's 0.2, formatter 0.1, first
    # calls 0.1 and 0.05; the first call inside the window left out
    ("first_use_s", 0.4 + 0.3 + 0.1 + 0.15),
    # 9 s less init 0.5, 0.8, 0.6 and driver 1.4, 2.0
    ("setup_outside_s", 9.0 - 5.3)])
def test_setup_metric_reads_the_phases(name, value):
    """Each ``setup_s`` metric reads its share of a synthetic recorder's
    phases, and nothing where the program records no phase (a recorder
    of spans alone) or the run has no slice."""
    metric = _metric(name)
    run = _phased_run()
    assert metric.read(run) == pytest.approx(value, rel=1e-12)
    assert metric.read(SimpleNamespace(**dict(vars(run), slice_bounds=None))) is None
    assert metric.read(SimpleNamespace(**dict(vars(_synthetic_run()), setup_s=9.0))) is None


def test_roofline_of_the_scrt_kernel_reads_its_bound():
    """B4's share of its bound at 2048 × 8194 float32: 72 B a cell over
    3.35 TB/s is 0.3608 ms a step, so 100 steps in 0.0725 s of ``step``
    kernels read 49.8%; another family's cell reads nothing."""
    bench_harness = importlib.import_module("benchmark.harness")
    spec = bench_harness.Spec(ROOT, "sc_rti.n2048.out100")
    nelem = 2048 * 8194
    run = SimpleNamespace(spec=spec, dtype="float32", nelem=nelem,
                          slice={"span_kernel_s": {"step": 0.0725}, "steps": 100})
    bound = nelem * 72 / 3.35e12
    value = _metric("roofline_pct.scrt_step").read(run)
    assert value == pytest.approx(100.0 * bound * 100 / 0.0725, rel=1e-12)
    assert 49.7 < value < 49.8
    assert _metric("roofline_pct.fakhari_step").read(run) is None


# ─── on the card ─────────────────────────────────────────────────────────
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("family,driver,text,kernel", [
    ("sc_step", apps.run_sc_laplace2d,
     "N 64\nRR 12\ntau 1.0\nout_freq 8\nvtk_freq 16\n", r"\bsc_step_kernel\b"),
    ("hcz_step", apps.run_rayleigh_taylor_pf,
     "N 32\nRe 100\nout_freq 8\nvtk_freq 16\n", r"\bhcz_step_kernel\b")])
def test_launch_counter_matches_profiled_kernels(cuda_device, tmp_path, family,
                                                 driver, text, kernel):
    """The driver's run on the card: ``kernel.launches.<family>`` grows by
    the kernels of the family that the profiler sees, the wrapper's spans
    carry the steps, the HCZ record enqueues its one kernel inside each
    record, and every record reads its diagnostics in ``wait``."""
    from torch.autograd import DeviceType

    cfg = tmp_path / "case.txt"
    cfg.write_text(text)
    run = lambda: driver(str(cfg), str(tmp_path / "o"),  # noqa: E731
                         dtype=torch.float32, max_steps=40, device=cuda_device)
    run()                                   # builds and loads the library
    launches = f"kernel.launches.{family}"
    before, steps_before = profiling.counter(launches), profiling.counter(
        f"kernel.steps.{family}")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    seen = [e.name for e in prof.events()
            if e.device_type != DeviceType.CPU and re.search(kernel, e.name)]
    assert profiling.counter(launches) == len(seen) == 40
    assert profiling.counter(f"kernel.steps.{family}") == 40
    assert before >= 40 and steps_before >= 40
    spans = profiling.spans()
    enq = [s for s in spans if s.name == "kernel.enqueue"
           and s.attrs["family"] == family]
    assert sum(s.attrs["steps"] for s in enq) == 40
    assert all(s.parent.name == "chunk" for s in enq)
    assert len([s for s in spans if s.name == "kernel.prepare"
                and s.attrs["family"] == family]) == len(enq)
    # the HCZ driver's record: one launch of its own family in each record
    records = [s for s in spans if s.name == "record"]
    rec = [s for s in spans if s.name == "kernel.enqueue" and s not in enq]
    assert all(s.attrs["family"] == "hcz_record" and s.parent.name == "record"
               for s in rec)
    assert len(rec) == (len(records) if family == "hcz_step" else 0)
    for r in (s for s in spans if s.name == "record"):
        assert any(s.name == "wait" and s.parent is r for s in spans)


_ONCE_SCRIPT = """
import json, sys, torch
from multiphase_lbm_tpu_torch.runners import apps
from multiphase_lbm_tpu_torch.utils import profiling
for dtype in (torch.float32, torch.float32, torch.float64):
    apps.run_sc_laplace2d(sys.argv[1], sys.argv[2], dtype=dtype, max_steps=8,
                          device="cuda")
print(json.dumps([[s.name, s.attrs, getattr(s.parent, "name", None)]
                  for s in profiling.spans()]))
"""


@pytest.mark.gpu
def test_library_load_once_and_kernel_first_once_per_entry(cuda_device, tmp_path):
    """A fresh process on the card that runs the SC driver twice in float32
    and once in float64, with no profiler: one ``device.context`` (inside
    the first ``init``), one ``library.load`` of the kernels, one
    ``kernel.first`` for each of ``sc_step_f32`` and ``sc_step_f64``
    (inside the call's ``driver``), and an ``init`` and a ``driver`` a
    call."""
    cfg = tmp_path / "case.txt"
    cfg.write_text("N 64\nRR 12\ntau 1.0\nout_freq 4\nvtk_freq 0\n")
    out = subprocess.run([sys.executable, "-c", _ONCE_SCRIPT, str(cfg),
                          str(tmp_path / "o")], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    phases = json.loads(out.stdout.strip().splitlines()[-1])
    names = [n for n, _, _ in phases]
    assert names.count("init") == names.count("driver") == 3
    assert [p for n, _, p in phases if n == "device.context"] == ["init"]
    loads = [a for n, a, _ in phases if n == "library.load"]
    assert loads == [{"lib": "kernels"}]
    first = [(a["entry"], a["family"], p) for n, a, p in phases
             if n == "kernel.first"]
    assert first == [("sc_step_f32", "sc_step", "driver"),
                     ("sc_step_f64", "sc_step", "driver")]
