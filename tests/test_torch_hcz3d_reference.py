"""The benchmark's plain reference of the 3D droplet
(``benchmark/configs/hcz_droplet3d_ref.py``) against the port, on the CPU.

The reference is written apart from the port, from the reference solver's
equations; these tests hold the two together at small boxes in float64:
its step against the port's plain path (``hcz3d_fused.run_fused_3d`` on a
CPU tensor) over 10 steps, and the ``energy.dat`` that ``run_laplace3d``
writes against its records, within 1e-12 of the column's largest value
(both sum in another order; the energy's velocities are a cancellation of
populations a thousand times larger, which leaves about 1e-14 of it), and
the ``sol_*.vtk`` dumps it writes against the reference's rendering.  The benchmark's
references must import neither JAX nor the program they check.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from multiphase_lbm_tpu_torch.models import hcz
from multiphase_lbm_tpu_torch.ops import hcz3d_fused
from multiphase_lbm_tpu_torch.runners import apps

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "benchmark" / "configs"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"bench_{name}", CONFIGS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("hcz_droplet3d_ref")


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _setup(N, Re):
    """The reference's parameters and the driver's initial state."""
    prm = REF.params({"N": N, "Re": Re})
    p = hcz.HCZParams(omega=prm["omega"], kappa=prm["kappa"])
    return prm, p, hcz.init_droplet_3d(N, N, N, p, dtype=torch.float64,
                                       device="cpu")


# ω = 1/τ: 1.11 at 12³ (Re 0.9) and 1.2 at 16³ (Re 1.44); at ω = 1 the
# (1 − ω) terms vanish
@pytest.mark.parametrize("N,Re", [(12, 0.9), (16, 1.44)])
def test_reference_step_matches_plain_path(N, Re):
    prm, p, state = _setup(N, Re)
    want = hcz3d_fused.run_fused_3d(*state, p, 10)
    got = REF.step(state, prm, 10)
    for a, b in zip(got, want):
        assert _gap(a, b) <= 1e-12


def test_driver_energy_matches_reference_records(tmp_path):
    N, Re, steps = 12, 0.9, 250
    case = tmp_path / "case.txt"
    case.write_text((CONFIGS / "hcz_droplet3d.txt").read_text()
                    + f"\nN {N}\nRe {Re}\nout_freq 100\nvtk_freq 0\n")
    apps.run_laplace3d(str(case), str(tmp_path / "out"), dtype=torch.float64,
                       max_steps=steps, device="cpu")
    prm = REF.params({"N": N, "Re": Re, "out_freq": 100, "vtk_freq": 0})
    _, _, state = _setup(N, Re)
    states = {}
    for it in range(0, steps, prm["out_freq"]):
        states[it] = state
        state = REF.step(state, prm, prm["out_freq"])
    want = REF.records(states, prm)["energy.dat"]
    lines = [[float(x) for x in line.split()]
             for line in (tmp_path / "out" / "energy.dat").read_text().splitlines()]
    assert len(lines) == REF.record_counts(prm, steps)["energy.dat"] == 3
    # per column, as the benchmark's check reads it: the gap over the
    # column's largest value (the file holds 16 significant digits)
    for col in range(2):
        scale = max(abs(row[col]) for row in want.values())
        for i, row in want.items():
            assert abs(lines[i][col] - row[col]) <= 1e-12 * scale
    assert not list((tmp_path / "out").glob("*.vtk"))
    assert REF.dump_count(prm, steps) == 0


def test_driver_dumps_match_reference_vtk_tokens(tmp_path):
    """``sol_*.vtk`` as the driver writes it at vtk_freq 100, under the
    reference's ``dump_name``, against the reference's ``vtk_tokens`` of
    its own states: every compared token equal, and as many dumps as
    ``dump_count`` gives."""
    N, Re, steps = 12, 0.9, 250
    case = tmp_path / "case.txt"
    case.write_text((CONFIGS / "hcz_droplet3d.txt").read_text()
                    + f"\nN {N}\nRe {Re}\nout_freq 100\nvtk_freq 100\n")
    out = tmp_path / "out"
    apps.run_laplace3d(str(case), str(out), dtype=torch.float64,
                       max_steps=steps, device="cpu")
    prm = REF.params({"N": N, "Re": Re, "out_freq": 100, "vtk_freq": 100})
    _, _, state = _setup(N, Re)
    assert len(list(out.glob("*.vtk"))) == REF.dump_count(prm, steps) == 3
    for it in range(0, steps, prm["vtk_freq"]):
        want, counted = REF.vtk_tokens(state, prm, it)
        got = (out / REF.dump_name(it)).read_text().split()
        assert len(got) == len(want) and sum(counted) > len(want) // 2
        assert [a for a, b, c in zip(got, want, counted) if c and a != b] == []
        state = REF.step(state, prm, prm["vtk_freq"])


@pytest.mark.parametrize("name", ["sc_droplet_ref", "hcz_rti_ref", "hcz_droplet3d_ref",
                                  "fakhari_bubble_ref", "sc_rti_ref"])
def test_reference_imports_neither_jax_nor_the_program(name):
    """Load the reference in a fresh interpreter in which importing JAX or
    either package raises, and list what it imported."""
    code = f"""
import importlib.abc, importlib.util, sys
BANNED = ("jax", "jaxlib", "multiphase_lbm_tpu", "multiphase_lbm_tpu_torch")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path, target=None):
        if fullname.split(".")[0] in BANNED:
            raise ImportError("the reference imported " + fullname)
for m in [m for m in sys.modules if m.split(".")[0] in BANNED]:
    del sys.modules[m]
sys.meta_path.insert(0, Refuse())
before = set(sys.modules)
spec = importlib.util.spec_from_file_location("ref", {str(CONFIGS / (name + ".py"))!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(sorted({{m.split(".")[0] for m in set(sys.modules) - before}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    imported = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not imported & {"jax", "jaxlib", "multiphase_lbm_tpu",
                           "multiphase_lbm_tpu_torch"}
