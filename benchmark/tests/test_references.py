"""The configurations' plain references against what the program writes, and
what they import; on the CPU, for every configuration in ``BENCHMARK.json``
and every ``benchmark/configs/*_ref.py``, so that a new configuration is
covered without an edit here:

    python3 -m pytest benchmark/tests -q
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.hooks import Hooks, resolve  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
REFERENCES = sorted(p.stem for p in (ROOT / "benchmark" / "configs").glob("*_ref.py"))
# dumps at 0 and EVERY (and at 2 · EVERY where the loop is inclusive)
EVERY = 10


def _first_cell(config):
    return next(w["name"] for w in BENCH["workloads"] if w["config"] == config)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_dumps_match_the_reference_tokens(config, tmp_path):
    """The configuration's driver at its rehearsal lattice in float64, with
    a dump every 10 steps: as many ``sol_*.vtk`` as the reference's
    ``dump_count`` gives, under its ``dump_name``, and every token that
    ``vtk_tokens`` compares (a quarter or more: at a small lattice many of
    a force's values are round-off) equal to its rendering of the state
    dumped."""
    spec = harness.Spec(ROOT, _first_cell(config))
    ref = spec.reference
    text, _ = spec.case_text(7, {**spec.config["rehearsal"],
                                 "out_freq": EVERY, "vtk_freq": EVERY})
    prm = ref.params(harness.parse_case(text))
    case = tmp_path / "case.txt"
    case.write_text(text)
    out = tmp_path / "out"
    steps = 2 * EVERY
    hooks = Hooks(spec.config, False)
    hooks.new_call(capture_its=(0, EVERY))
    with hooks:
        harness._call(resolve(spec.config["driver"])[2], case, out, torch.float64,
                      steps, "cpu")
    assert len(list(out.glob("*.vtk"))) == ref.dump_count(prm, steps)
    assert sorted(hooks.captured) == [0, EVERY]
    for it, state in hooks.captured.items():
        want, counted = ref.vtk_tokens(state, prm, it)
        got = (out / ref.dump_name(it)).read_text().split()
        assert len(got) == len(want) and sum(counted) > len(want) // 4
        assert [(k, a, b) for k, (a, b, c) in enumerate(zip(got, want, counted))
                if c and a != b] == []


@pytest.mark.parametrize("name", REFERENCES)
def test_reference_imports_neither_jax_nor_the_program(name):
    """Load the reference in a fresh interpreter in which importing JAX or
    either package raises, and list what it imported."""
    code = f"""
import importlib.abc, importlib.util, sys
BANNED = ("jax", "jaxlib", "flax", "multiphase_lbm_tpu", "multiphase_lbm_tpu_torch")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path, target=None):
        if fullname.split(".")[0] in BANNED:
            raise ImportError("the reference imported " + fullname)
for m in [m for m in sys.modules if m.split(".")[0] in BANNED]:
    del sys.modules[m]
sys.meta_path.insert(0, Refuse())
before = set(sys.modules)
spec = importlib.util.spec_from_file_location(
    "ref", {str(ROOT / "benchmark" / "configs" / (name + ".py"))!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(sorted({{m.split(".")[0] for m in set(sys.modules) - before}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    imported = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not imported & {"jax", "jaxlib", "flax", "multiphase_lbm_tpu",
                           "multiphase_lbm_tpu_torch"}
