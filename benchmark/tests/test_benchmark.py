"""Self-test of the benchmark, on the CPU (run from the repo root):

    python3 -m pytest benchmark/tests -q

It rehearses every cell at a tiny lattice through the program's plain
path and checks that a sound run comes out correct, that the control (the
plain reference one precision below the cell's, in the program's place)
and each fault a cell can have (``faults.py``) come out not correct, that
the trace arithmetic reads a known trace right, that ``BENCHMARK.json``
keeps the benchmark contract's rules, that a run whose process holds JAX
or the JAX package gives no result, and that the command refuses to run
without a card.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmark import harness, trace  # noqa: E402
from faults import STEP_FAULTS, plant_half_lattice  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
# the tiny rehearsal keeps the cell's cadence unless it would take
# thousands of plain steps on the CPU
FAST = {"out_freq": 400}


def rehearse(workload, seed=7, control=False):
    spec = harness.Spec(ROOT, workload)
    shape = dict(spec.config["rehearsal"])
    if spec.cell["set"].get("out_freq", 0) > FAST["out_freq"]:
        shape.update(FAST)
    return harness.run(spec, seed, 0.3, False, "cpu", time.perf_counter(),
                       shape=shape, control=control)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct_and_control_is_not(workload):
    r = rehearse(workload, control=True)
    assert r["correct"], r["checks"]
    assert not r["control_correct"], (r["control"], r["checks"])
    assert r["metrics"] == {} and r["device"]["platform"] == "cpu"
    assert list(r)[-1] == "checks"


def _stepping(workload):
    spec = harness.Spec(ROOT, workload)
    mod, _, name = spec.config["stepping"].partition(":")
    return mod, name


@pytest.mark.parametrize("fault", sorted(STEP_FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_step_fault_is_not_correct(workload, fault, monkeypatch):
    import importlib
    mod, name = _stepping(workload)
    module = importlib.import_module(mod)
    monkeypatch.setattr(module, name, STEP_FAULTS[fault](getattr(module, name)))
    r = rehearse(workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_half_lattice_diagnostics_is_not_correct(workload, monkeypatch):
    """Each diagnostic the configuration lists taken over half the lattice."""
    plant_half_lattice(harness.Spec(ROOT, workload).config, monkeypatch)
    r = rehearse(workload)
    assert not r["correct"], r["checks"]


def _dumping_workload():
    """The first cell that holds its dumps to a ``vtk_mismatch`` limit."""
    for name in WORKLOADS:
        if "vtk_mismatch" in harness.Spec(ROOT, name).cell["limits"]:
            return name
    return None


def test_altered_dump_is_not_correct(monkeypatch):
    """The first float field of every dump ×1.00001 as the writer takes it."""
    workload = _dumping_workload()
    assert workload is not None, "no cell holds its dumps to a vtk_mismatch limit"
    from multiphase_lbm_tpu_torch.io import vtk
    orig = vtk.VtkWriter.scalar

    def scalar(self, name, data, as_int=False):
        if not as_int and not getattr(self, "_altered", False):
            self._altered = True
            data = data * 1.00001
        return orig(self, name, data, as_int)
    monkeypatch.setattr(vtk.VtkWriter, "scalar", scalar)
    r = rehearse(workload)
    assert not r["correct"], r["checks"]
    assert r["checks"]["vtk_mismatch"]["value"] > r["checks"]["vtk_mismatch"]["limit"]


@pytest.mark.parametrize("name", sorted(harness.FOREIGN))
def test_foreign_module_in_the_timed_process_gives_no_result(name, monkeypatch):
    """A stub under a JAX name, loaded by the stepping entry inside the
    window: the run raises and no result comes back."""
    import importlib
    import types
    mod, attr = _stepping(WORKLOADS[0])
    module = importlib.import_module(mod)
    orig = getattr(module, attr)

    def run_fused(*args, **kw):
        monkeypatch.setitem(sys.modules, name + ".stub", types.ModuleType(name + ".stub"))
        return orig(*args, **kw)
    monkeypatch.setattr(module, attr, run_fused)
    result = None
    with pytest.raises(harness.ForeignModules, match=re.escape(name)):
        result = rehearse(WORKLOADS[0])
    assert result is None


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    import types
    for name in ("jaxtyping", "flaxen.core", "multiphase_lbm_tpu_torch.stub"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.foreign_modules() == ["jaxlib"]


def test_trace_reduction_reads_a_known_trace():
    ev = [
        {"cat": "user_annotation", "name": "bench.step", "ts": 0, "dur": 10, "tid": 1},
        {"cat": "user_annotation", "name": "bench.log", "ts": 50, "dur": 10, "tid": 1},
        {"cat": "user_annotation", "name": "bench.vtk_write", "ts": 80, "dur": 30, "tid": 2},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 55, "dur": 1, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "k1", "ts": 20, "dur": 30, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "k2", "ts": 70, "dur": 10, "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 100, "dur": 5, "args": {"correlation": 3}},
    ]
    r = trace.reduce(ev, wall_s=200e-6, steps=4)
    assert r["kernels"] == 2 and r["steps"] == 4
    assert r["busy_s"] == pytest.approx(45e-6)
    assert r["span_kernel_s"] == pytest.approx({"step": 30e-6, "log": 10e-6})
    assert r["idle_gaps"] == [["log", pytest.approx(20e-6)], ["diagnostics", pytest.approx(20e-6)]]
    assert r["device_ops"][0] == ["k1", pytest.approx(30e-6)]


@pytest.mark.parametrize("traced", [False, True])
def test_record_gap_leaves_out_the_traced_slice(traced):
    from types import SimpleNamespace
    gap = harness.load_module(ROOT / "benchmark" / "metrics" / "record_gap_p95_ms.py")
    # 40 gaps of 0.1 s, one of them 0.7 s long where the profiler stops
    records = [0.1 * i for i in range(21)] + [2.7 + 0.1 * i for i in range(20)]
    run = SimpleNamespace(records=records,
                          slice_bounds=(1.05, 2.05) if traced else None)
    value = gap.read(run)
    if traced:
        assert value == pytest.approx(100.0)
    else:
        assert value > 100.0
    assert gap.read(SimpleNamespace(records=records[:20], slice_bounds=None)) is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    for p in b["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "cells" / f"{w['name']}.json").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        mine = lambda m: w in m.get("workloads", cells)  # noqa: E731
        assert sum(map(mine, b["end_to_end"])) >= 2
        assert any(map(mine, b["per_layer"]))
    assert len(json.dumps(b)) <= 64 * 1024


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
                        "--seed", "1", "--seconds", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
