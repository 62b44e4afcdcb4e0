"""A configuration that the benchmark has never run, rehearsed from its files
alone, and the half-lattice fault on any diagnostic's signature; on the CPU:

    python3 -m pytest benchmark/tests -q

The root this test writes holds a ``BENCHMARK.json`` with one
configuration and one cell of the Fakhari bubble (``run_young_laplace2d``,
whose loop runs to ``max_steps`` inclusive), its case template, its cell
and work files and a reference module.  The reference is a stand-in: it
steps with the program's own plain model (``models.fakhari.run``) and
writes the ``energy.dat`` and ``mass.dat`` lines from the state as the
driver does, because this test checks the harness, not the physics.  A
benchmark's reference is written apart from the program and imports
nothing of it.

The fault wrapper is also held to the one the self-test planted before
configurations named their diagnostics: the same cut, and the same value,
on the diagnostics of every configuration in ``BENCHMARK.json``.
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmark import harness  # noqa: E402
from benchmark.hooks import resolve  # noqa: E402
from faults import STEP_FAULTS, half_lattice, plant_half_lattice  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIG = "bubble"
WORKLOAD = "bubble.n24.out20"
CHECK_STEPS = 3

TEMPLATE = """# the reference's Young-Laplace case (Young_Laplace2D.h defaults)
N         128
tf        10000
out_freq  1000
vtk_freq  1000
Sigma     0.01
W         4.0
M         0.02
RhoL      0.001
RhoH      1.0
tau       0.8
"""

REFERENCE = '''"""A stand-in reference of the Fakhari bubble for the harness's self-test:
the program's plain model steps it, and the records are formed from the
state as the driver forms them."""
import torch

from multiphase_lbm_tpu_torch.models import fakhari as fk


def params(cfg):
    def num(key, default):
        return float(cfg.get(key, default))

    N = int(num("N", 128))
    return {"nx": N, "ny": N, "cells": N * N, "sigma": num("Sigma", 0.01),
            "W": num("W", 4.0), "M": num("M", 0.02), "rhol": num("RhoL", 0.001),
            "rhoh": num("RhoH", 1.0), "tau": num("tau", 0.8),
            "out_freq": int(num("out_freq", 1000)),
            "vtk_freq": int(num("vtk_freq", 1000))}


def _p(prm):
    return fk.FakhariParams(rhol=prm["rhol"], rhoh=prm["rhoh"], sigma=prm["sigma"],
                            W=prm["W"], M=prm["M"], tau=prm["tau"])


def step(state, prm, n):
    return tuple(fk.run(tuple(state), _p(prm), n))


def records(states, prm):
    out = {"energy.dat": {}, "mass.dat": {}}
    for it, (h, _, u) in states.items():
        if it % prm["out_freq"]:
            continue
        line = it // prm["out_freq"]
        e = 0.5 * (u * u).sum() / (u.shape[-1] * u.shape[-2])
        m = (prm["rhol"] + h.sum(dim=0) * (prm["rhoh"] - prm["rhol"])).sum()
        out["energy.dat"][line] = [it, float(e)]
        out["mass.dat"][line] = [it, float(m)]
    return out


def record_counts(prm, steps):
    # the driver records at every multiple of out_freq up to steps inclusive
    n = steps // prm["out_freq"] + 1 if prm["out_freq"] else 0
    return {"energy.dat": n, "mass.dat": n}


def dump_count(prm, steps):
    return steps // prm["vtk_freq"] + 1 if prm["vtk_freq"] else 0


def dump_name(it):
    return f"sol_{it:07d}.vtk"


def vtk_tokens(state, prm, it):
    raise NotImplementedError("the rehearsal's cell writes no dumps")
'''

PROGRAM = "multiphase_lbm_tpu_torch"
CONFIG_FILE = {
    "name": CONFIG,
    "template": f"{CONFIG}.txt",
    "driver": f"{PROGRAM}.runners.apps:run_young_laplace2d",
    "stepping": f"{PROGRAM}.ops.fakhari_fused:run_fused",
    "state_args": 3,
    "steps_arg": 4,
    "record_file": "energy.dat",
    # the bubble is symmetric about the lattice's middle row, so the mean
    # energy over the lower half equals the whole's: the mass catches it
    "diagnostics": [f"{PROGRAM}.models.fakhari:kinetic_energy",
                    f"{PROGRAM}.models.fakhari:total_mass"],
    "hooks": {"window_start": f"{PROGRAM}.runners.common:Driver.__init__",
              "record": f"{PROGRAM}.io.loggers:DatLogger.log",
              "vtk": f"{PROGRAM}.runners.common:Driver.write_vtk",
              "vtk_write": f"{PROGRAM}.io.vtk:VtkWriter.write"},
    "reference": f"{CONFIG}_ref.py",
    "work": {"family": "fakhari_step", "mask": False},
    "rehearsal": {"N": 16},
}

CELL = {"dtype": "float64",
        "set": {"N": 24, "out_freq": 20, "vtk_freq": 0},
        "seeded": {"Sigma": [0.009, 0.011]},
        "warmup_steps": 20,
        "check_steps": CHECK_STEPS,
        "limits": {"state_err": 1e-10, "record_err": 1e-10, "missing": 0}}

WORK = {"family": "fakhari_step",
        "bytes_per_cell": {"float32": {"populations": 160},
                           "float64": {"populations": 320}},
        "flop_per_cell": 400}


def _write(path: Path, data):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(data if isinstance(data, str) else json.dumps(data, indent=1))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A root whose ``benchmark/`` holds nothing but the new configuration's
    files and the table of peaks."""
    root = tmp_path_factory.mktemp("root")
    home = root / "benchmark"
    _write(root / "BENCHMARK.json", {
        "command": ["python3", "benchmark/run.py"], "paths": ["benchmark"],
        "run_seconds": 10,
        "configs": [{"name": CONFIG, "source": "Fakhari et al. 2017",
                     "file": f"benchmark/configs/{CONFIG}.json", "reduced": ["N"],
                     "why": "a configuration the harness has never run"}],
        "workloads": [{"name": WORKLOAD, "config": CONFIG, "traffic": "n24.out20",
                       "chips": 1, "why": "records every 20 steps, no dumps"}],
        "end_to_end": [{"name": "mlups", "unit": "MLUPS", "better": "higher",
                        "bound": 0.25, "source": "host_clock"}],
        "per_layer": []})
    _write(home / "configs" / f"{CONFIG}.json", CONFIG_FILE)
    _write(home / "configs" / f"{CONFIG}.txt", TEMPLATE)
    _write(home / "configs" / f"{CONFIG}_ref.py", REFERENCE)
    _write(home / "cells" / f"{WORKLOAD}.json", CELL)
    _write(home / "work" / "fakhari_step.json", WORK)
    shutil.copy(ROOT / "benchmark" / "peaks.json", home / "peaks.json")
    return root


def _rehearse(root, seed=7):
    spec = harness.Spec(root, WORKLOAD)
    return harness.run(spec, seed, 0.3, False, "cpu", time.perf_counter(),
                       shape=spec.config["rehearsal"])


def test_spec_reads_the_root_it_is_given(root):
    spec = harness.Spec(root, WORKLOAD)
    assert spec.home == root / "benchmark"
    assert spec.cell == CELL and spec.work == WORK
    assert [m["name"] for m in spec.end_to_end] == ["mlups"]


def test_sound_run_is_correct_to_the_end_of_the_call(root):
    """The chunk that ends at ``max_steps`` is ``check_steps`` long; the
    driver's inclusive loop takes one step more, which the comparison
    counts."""
    r = _rehearse(root)
    assert r["correct"], r["checks"]
    run = r["run"]
    assert run["compared_steps"] == CHECK_STEPS + 1
    assert run["steps"] == run["max_steps"] + 1
    assert r["checks"]["missing"]["value"] == 0


@pytest.mark.parametrize("fault", sorted(STEP_FAULTS))
def test_step_fault_is_not_correct(root, fault, monkeypatch):
    import importlib
    mod, _, name = CONFIG_FILE["stepping"].partition(":")
    module = importlib.import_module(mod)
    monkeypatch.setattr(module, name, STEP_FAULTS[fault](getattr(module, name)))
    r = _rehearse(root)
    assert not r["correct"], r["checks"]


def test_half_lattice_diagnostics_is_not_correct(root, monkeypatch):
    plant_half_lattice(harness.Spec(root, WORKLOAD).config, monkeypatch)
    r = _rehearse(root)
    assert not r["correct"], r["checks"]
    assert r["checks"]["record_err"]["value"] > r["checks"]["record_err"]["limit"]


# ── the fault wrapper against the one it replaced ──

def _half_energy(orig):
    """The half-lattice fault as the self-test planted it before
    configurations named their diagnostics: ``kinetic_energy(state, fluid,
    ...)`` only."""
    def kinetic_energy(state, fluid, *a, **kw):
        f = state[0] if isinstance(state, tuple) else state
        ny = f.shape[1]
        cut = (tuple(s[:, : ny // 2] for s in state) if isinstance(state, tuple)
               else state[:, : ny // 2])
        return orig(cut, fluid[: ny // 2], *a, **kw)
    return kinetic_energy


def _diagnostic_calls(config_name, tmp_path, monkeypatch):
    """The arguments of every call of the configuration's diagnostics in a
    float64 driver call at its rehearsal lattice, records at 0 and 10."""
    workload = next(w["name"] for w in BENCH["workloads"] if w["config"] == config_name)
    spec = harness.Spec(ROOT, workload)
    text, _ = spec.case_text(7, {**spec.config["rehearsal"], "out_freq": 10, "vtk_freq": 0})
    case = tmp_path / "case.txt"
    case.write_text(text)
    calls = []
    for target in spec.config["diagnostics"]:
        owner, attr, orig = resolve(target)

        def spy(*a, _orig=orig, **kw):
            calls.append((_orig, a, kw))
            return _orig(*a, **kw)
        monkeypatch.setattr(owner, attr, spy)
    harness._call(resolve(spec.config["driver"])[2], case, tmp_path / "out",
                  torch.float64, 11, "cpu")
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_half_lattice_cuts_as_before(config, tmp_path, monkeypatch):
    calls = _diagnostic_calls(config, tmp_path, monkeypatch)
    assert len(calls) >= 2
    for orig, a, kw in calls:
        want = _half_energy(orig)(*a, **kw)
        got = half_lattice(orig)(*a, **kw)
        assert torch.equal(got, want)
    # the record at step 10: the cut changes what the diagnostic reads
    orig, a, kw = calls[-1]
    assert not torch.equal(half_lattice(orig)(*a, **kw), orig(*a, **kw))


def test_half_lattice_wraps_any_signature():
    """``kinetic_energy(state)`` of the Fakhari model and
    ``kinetic_energy(state, tab)`` of the combustion model, against the
    same functions on arguments cut by hand."""
    from multiphase_lbm_tpu_torch.models import combustion as cb
    from multiphase_lbm_tpu_torch.models import fakhari as fk

    gen = torch.Generator().manual_seed(3)
    ny, nx = 10, 12
    state = tuple(torch.rand((q, ny, nx), generator=gen, dtype=torch.float64)
                  for q in (9, 9, 2))
    got = half_lattice(fk.kinetic_energy)(state)
    assert torch.equal(got, fk.kinetic_energy(tuple(t[:, :ny // 2] for t in state)))
    assert not torch.equal(got, fk.kinetic_energy(state))

    p = cb.CombustionParams(nx=40, ny=16)
    flags, _ = cb.build_geometry(p)
    tab = cb.build_static_tables(flags, p)
    st = cb.initialize(p, torch.float64, flags=flags, device="cpu")
    st = st._replace(f=st.f * (1.0 + 0.1 * torch.rand(st.f.shape, generator=gen,
                                                     dtype=torch.float64)))
    got = half_lattice(cb.kinetic_energy)(st, tab)
    cut_st = type(st)(*(t[..., : p.ny // 2, :] for t in st))
    cut_tab = {k: v[..., : p.ny // 2, :] for k, v in tab.items() if k != "_on_device"}
    assert torch.equal(got, cb.kinetic_energy(cut_st, cut_tab))
    assert "_on_device" not in tab or all(
        t.shape[-2] == p.ny for t in tab["_on_device"].values())
