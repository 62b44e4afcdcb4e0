"""The port's own spans and counters (``utils/profiling``): the recorder,
the driver loop's spans and bytes read to the host, the kernel wrappers'
launch counters, the operator's ``--profile`` exporter and the benchmark's
three per-layer metrics that read them.

The CPU tests run the plain path, which enqueues no kernel, so the
``kernel.*`` spans and launch counters are checked by the ``gpu`` tests
at the end, which skip without a card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_tracing.py
"""
import importlib.util
import json
import re
import threading
from pathlib import Path
from types import SimpleNamespace

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
    # each record reads the energy and φ for the host's interface scan;
    # each dump stages φ and the density (the Flag field is host data); the
    # Flag is read once, as a bool mask, before the loop
    reads = {"record": 8 + n * 8, "dump": 2 * n * 8}
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
    driver_span, = [s for s in spans if s.thread == main and s.parent is None]
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
    assert "profile: trace written to" in capsys.readouterr().out


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
    slice; 800 sc_step steps in 1.2 ms of wrapper spans, an hcz_step call
    that is not the cell's family, and d2h_bytes of 67,125,264 B in it."""
    def s(name, t0, t1, thread=1, **attrs):
        return SimpleNamespace(name=name, t0=t0, t1=t1, thread=thread,
                               attrs=attrs, parent=None)
    spans = [
        s("record", 9.0, 9.01), s("wait", 9.001, 9.002),
        s("kernel.enqueue", 9.02, 9.03, family="sc_step", steps=400),
        s("record", 11.0, 11.010), s("wait", 11.001, 11.004),
        s("wait", 11.005, 11.006), s("log", 11.007, 11.008),
        s("chunk", 11.010, 11.020),
        s("kernel.prepare", 11.011, 11.0115, family="sc_step", steps=400),
        s("kernel.enqueue", 11.012, 11.0121, family="sc_step", steps=400),
        s("vtk.write", 11.5, 11.9, thread=2),
        s("record", 12.0, 12.0025), s("wait", 12.001, 12.002),
        s("chunk", 12.0025, 12.006),
        s("kernel.prepare", 12.003, 12.0035, family="sc_step", steps=400),
        s("kernel.enqueue", 12.004, 12.0041, family="sc_step", steps=400),
        s("kernel.enqueue", 12.5, 12.6, family="hcz_step", steps=9),
        s("record", 13.0, 13.002), s("wait", 13.0, 13.001),
        s("record", 25.0, 25.01), s("wait", 25.001, 25.002),
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
    ("d2h_mb_per_record", 67.125264 / 3)])
def test_metric_reads_a_synthetic_recorder(name, value):
    metric = _metric(name)
    assert metric.read(_synthetic_run()) == pytest.approx(value, rel=1e-9)
    assert metric.read(SimpleNamespace(**dict(vars(_synthetic_run()),
                                              slice_bounds=None))) is None


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
    carry the steps, and every record reads its diagnostics in ``wait``."""
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
    enq = [s for s in spans if s.name == "kernel.enqueue"]
    assert sum(s.attrs["steps"] for s in enq) == 40
    assert all(s.attrs["family"] == family and s.parent.name == "chunk"
               for s in enq)
    assert len([s for s in spans if s.name == "kernel.prepare"]) == len(enq)
    for r in (s for s in spans if s.name == "record"):
        assert any(s.name == "wait" and s.parent is r for s in spans)
