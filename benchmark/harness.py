"""One run of one cell: set-up, one timed call of the program's own driver,
the check against the plain reference, and the metrics.

Everything that belongs to a configuration, a cell or a metric is data
that this module finds by name (``BENCHMARK.json``, ``configs/``,
``cells/``, ``metrics/``, ``work/``); nothing here names a model.

:class:`Spec` reads them under ``<root>/benchmark`` of the root it is
given, so a test can rehearse a configuration in a root of its own.

* The case file is the configuration's template (the reference's own
  ``config_*.txt``) with the cell's keys appended, and the keys the cell
  draws from ``--seed`` (the parser keeps a key's last value).
* Set-up: one call of the driver for one step at the configuration's tiny
  rehearsal lattice (it builds and loads the kernel library on first use),
  then the cell's warm-up call, whose rate
  sizes the timed call: ``max_steps = k · out_freq + check_steps``, with k
  records filling ``--seconds``.  The chunk that ends at ``max_steps`` is
  then ``check_steps`` long; the stepping calls that follow it in the same
  call (a driver whose loop runs to ``max_steps`` inclusive takes one more
  step) add theirs to it, and the reference repeats them all.
* The window is the timed call of the driver, from the moment it builds
  its ``Driver`` (after making the lattice's initial state; the reference's
  MLUPS clock starts there too) to its return, after ``Driver.finish`` has
  drained the dumps.  The call's initial state counts as set-up.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import check, roofline
from .hooks import Hooks, Slice, resolve

HERE = Path(__file__).resolve().parent
# the traced slice starts at the first record past this share of the
# window and lasts at least this long
SLICE_START = 0.25
SLICE_SECONDS = 2.0
# top-level modules the timed process may not hold once the window has
# closed: JAX, what loads with it, and the JAX package the port replaces
FOREIGN = frozenset({"jax", "jaxlib", "flax", "multiphase_lbm_tpu"})


class ForeignModules(RuntimeError):
    """The timed process holds a module of :data:`FOREIGN`."""


def foreign_modules():
    """The names of :data:`FOREIGN` that ``sys.modules`` holds, compared by
    whole top-level names (the port's own name begins with the JAX
    package's)."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & FOREIGN)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse_case(text: str) -> dict:
    """``key value`` lines, ``#`` to the end of a line a comment, a later
    line overriding an earlier one: the grammar of the reference's
    ``config_*.txt`` files."""
    keys = {}
    for line in text.splitlines():
        parts = line.split("#", 1)[0].split()
        if len(parts) >= 2:
            keys[parts[0]] = parts[1]
    return keys


class Spec:
    """A workload of ``BENCHMARK.json`` with its cell, configuration,
    reference and metrics."""

    def __init__(self, root: Path, workload: str):
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
        self.workload = cells[workload]
        self.chips = self.workload["chips"]
        entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        cfg_path = root / entry["file"]
        self.config = load_json(cfg_path)
        self.home = root / HERE.name
        self.cell = load_json(self.home / "cells" / f"{workload}.json")
        self.template = (cfg_path.parent / self.config["template"]).read_text()
        self.reference = load_module(cfg_path.parent / self.config["reference"])
        self.work = load_json(self.home / "work" / f"{self.config['work']['family']}.json")
        self.peaks = load_json(self.home / "peaks.json")

        def mine(m):
            return workload in m.get("workloads", [workload])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def case_text(self, seed: int, shape=None):
        """The case file of ``seed``, and the seeded draw it came from."""
        rng = np.random.default_rng(seed % (1 << 64))
        keys = dict(self.cell["set"])
        for key in sorted(self.cell["seeded"]):
            lo, hi = self.cell["seeded"][key]
            keys[key] = float(rng.uniform(lo, hi))
        keys.update(shape or {})
        lines = [self.template.rstrip("\n"), "", "# the benchmark cell's keys"]
        lines += [f"{k} {v!r}" for k, v in keys.items()]
        return "\n".join(lines) + "\n", rng


def _call(driver, case, outdir, dtype, steps, device):
    with contextlib.redirect_stdout(sys.stderr):
        out = driver(str(case), str(outdir), dtype=dtype, max_steps=steps,
                     device=device)
    return out if isinstance(out, tuple) else (out,)


def run(spec: Spec, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, shape=None, control=False):
    """One run; returns the result line as a dict (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``checks``; ``breakdown`` when
    traced).  Raises :class:`ForeignModules`, and returns no result, where
    the process holds JAX or the JAX package once the check has run.  ``shape`` overrides case keys (the CPU rehearsal's tiny
    lattice); ``control`` adds the control's readings under ``control``."""
    import torch

    cuda = torch.device(device).type == "cuda"
    dtype_name = spec.cell["dtype"]
    dtype = getattr(torch, dtype_name)
    text, rng = spec.case_text(seed, shape)
    prm = spec.reference.params(parse_case(text))
    o, r = prm["out_freq"], spec.cell["check_steps"]
    if not (0 < r < o and (prm["vtk_freq"] == 0 or (o % prm["vtk_freq"] == 0 and r < prm["vtk_freq"]))):
        raise ValueError("check_steps must be shorter than every cadence, "
                         "and out_freq a multiple of vtk_freq")
    driver = resolve(spec.config["driver"])[2]
    tmp = Path(tempfile.mkdtemp(prefix="bench-"))
    try:
        case = tmp / "case.txt"
        case.write_text(text)
        hooks = Hooks(spec.config, trace)
        with hooks:
            # the first call, at the rehearsal's tiny lattice, builds and
            # loads the kernel library and starts the card's context
            warm0 = tmp / "warm0.txt"
            warm0.write_text(spec.case_text(seed, spec.config["rehearsal"])[0])
            _call(driver, warm0, tmp / "warm0", dtype, 1, device)
            hooks.new_call()
            t_call = time.perf_counter()
            _call(driver, case, tmp / "warm1", dtype, spec.cell["warmup_steps"], device)
            t_end = time.perf_counter()
            init_s = hooks.driver_t - t_call
            per_step = (t_end - hooks.driver_t) / spec.cell["warmup_steps"]
            k = max(2, round(seconds / (o * per_step)))
            max_steps = k * o + r
            j = 1 + int(rng.random() * (k - 1))
            sample = sorted({j * o, k * o})
            dumps = [i for i in sample if prm["vtk_freq"] and i % prm["vtk_freq"] == 0]
            shutil.rmtree(tmp / "warm0")
            shutil.rmtree(tmp / "warm1")
            slice_ = None
            if trace:
                _warm_profiler(device)
                start = math.ceil(SLICE_START * k) * o
                slice_ = Slice(start, SLICE_SECONDS, o)
            hooks.new_call(capture_its=sample, slice_=slice_, final_it=max_steps)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            final = _call(driver, case, tmp / "run", dtype, max_steps, device)
            t1 = time.perf_counter()
            t0 = hooks.driver_t
            if slice_ is not None:
                slice_.stop(hooks.it)
        peak = torch.cuda.max_memory_allocated() if cuda else None
        outdir = tmp / "run"
        ref = spec.reference
        captured, last = hooks.captured, hooks.last
        exp = check.expected_outputs(ref, prm, captured, last, dumps)
        got = check.program_outputs(final, outdir, exp["records"], dumps, ref)
        readings = check.compare(got, exp, where := {})
        for name, at in where.items():
            print(f"worst {name}: {at}", file=sys.stderr)
        readings["missing"] = check.missing(outdir, ref, prm, max_steps)
        ctl = None
        if control:
            ctl = check.compare(check.control_outputs(
                ref, prm, captured, last, dumps, dtype_name), exp)
        sliced = None
        if slice_ is not None and slice_.steps:
            from . import trace as trace_mod
            sliced = trace_mod.reduce(trace_mod.events(slice_.prof),
                                      slice_.t1 - slice_.t0, slice_.steps)
        ctx = SimpleNamespace(
            spec=spec, prm=prm, dtype=dtype_name, nelem=prm["cells"],
            steps=hooks.it, window_s=t1 - t0, setup_s=t0 - t_start,
            records=hooks.records, spans=hooks.spans, slice=sliced,
            slice_bounds=(slice_.t0, slice_.t1) if sliced else None)
        result = _result(spec, ctx, readings, trace, cuda, peak, sliced)
        result["run"] = {"seed": seed, "max_steps": max_steps, "steps": hooks.it,
                         "compared_steps": last[2], "records": k + 1,
                         "sampled_records": [i // o for i in sample],
                         "init_s": init_s, "warm_ms_per_step": per_step * 1e3,
                         "intervals_ms": [float(v) * 1e3 for v in np.percentile(
                             np.diff(hooks.records), [0, 25, 50, 75, 95, 100])],
                         "case": {key: prm[key] for key in sorted(prm)}}
        if ctl is not None:
            result["control"] = ctl
            result["control_correct"] = all(
                ctl[n] <= lim for n, lim in spec.cell["limits"].items() if n in ctl)
        result["checks"] = result.pop("checks")
        found = foreign_modules()
        if found:
            raise ForeignModules("the timed process holds " + ", ".join(found))
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _warm_profiler(device):
    """Start and stop one profiler session in set-up, so that starting the
    slice inside the window finds the profiler's libraries loaded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.ones(8, device=device).sum().item()


def _result(spec, ctx, readings, trace, cuda, peak, sliced):
    import torch

    limits = spec.cell["limits"]
    checks = {name: {"value": readings[name], "limit": limits[name]}
              for name in limits}
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    metrics = {}
    if cuda and trace:
        t, by = roofline.bound_s(ctx)
        print(f"bound: {spec.config['work']['family']} is bound by {by}, "
              f"{t * 1e3:.6g} ms a step at the data-sheet peaks", file=sys.stderr)
    if cuda:
        for m in (spec.per_layer if trace else spec.end_to_end):
            value = load_module(spec.home / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": failed == 0, "attempted": len(checks),
              "failed": failed, "metrics": metrics}
    if cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": spec.chips, "memory_peak_bytes": peak}
        if trace and sliced is not None:
            dev["busy_s"] = sliced["busy_s"]
            dev["window_s"] = sliced["window_s"]
        result["device"] = dev
        if trace and sliced is not None:
            result["breakdown"] = {"device_ops": sliced["device_ops"],
                                   "idle_gaps": sliced["idle_gaps"]}
    else:
        result["device"] = {"platform": "cpu", "rehearsal": True}
    result["checks"] = checks
    return result
