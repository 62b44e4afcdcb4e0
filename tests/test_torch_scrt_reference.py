"""The benchmark's plain reference of the SC Rayleigh–Taylor channel
(``benchmark/configs/sc_rti_ref.py``) against the port and against the C++
capture, on the CPU.

The reference is written apart from the port, from the reference solver's
equations; these tests hold the two together in float64, each within 1e-12
of the field's or the column's largest value: both sum the force and the
moments in another order, which leaves a few 1e-15 a step.  The step is
compared against the port's plain path (``scrt_fused.run_fused`` on CPU
tensors) on a 24 × 34 channel, so that an x/y swap shows, from the
interface with seeded noise on f, so that every term of the force and of
the Guo source is exercised away from symmetry, at ω = 1.25 and 0.9, so
that the (1 − ω) f term shows.  Against the C++ capture
(``multiphase_lbm_tpu/validation/data/scrt_reference.npz``, read by path as
data) the reference's probe columns after 250 steps at N = 128 are held to
5e-5, the capture's float output precision, as the port is
(``tests/test_torch_scrt.py``), and the record's spike/bubble rule to the
capture's rows.  The driver (``run_rayleigh_taylor_sc``) is compared from
the reference's own initial state: its three ``.dat`` files, their line
counts, and its ``sol_*.vtk`` dumps.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch.models import shan_chen_rt as rt
from multiphase_lbm_tpu_torch.ops import scrt_fused
from multiphase_lbm_tpu_torch.runners import apps

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "benchmark" / "configs"
CAPTURE = ROOT / "multiphase_lbm_tpu" / "validation" / "data" / "scrt_reference.npz"
spec = importlib.util.spec_from_file_location("bench_sc_rti_ref",
                                              CONFIGS / "sc_rti_ref.py")
REF = importlib.util.module_from_spec(spec)
spec.loader.exec_module(REF)
TOL = 1e-12
# the capture holds the C++ float output: ρ to about 5e-5
CAPTURE_ATOL = 5e-5


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_initial_state_matches_the_port():
    prm = REF.params({"N": 24})
    f, = REF.initial(prm)
    p = rt.SCRTParams(omega=prm["omega"])
    fluid = rt.geometry_channel(prm["nx"], prm["ny"], device="cpu")
    want = rt.init_interface(prm["nx"], prm["ny"], p, device="cpu") * fluid[None]
    assert f.shape == want.shape == (9, 98, 24)
    assert _gap(f, want) <= 1e-15


@pytest.mark.parametrize("omega", [1.25, 0.9])
def test_reference_step_matches_plain_path(omega):
    nx, ny = 24, 34
    prm = dict(REF.params({}), nx=nx, ny=ny, cells=nx * ny, omega=omega)
    f, = REF.initial(prm)
    gen = torch.Generator().manual_seed(24)
    # ±5e-4 on populations of at least 0.011 (w = 1/36 at ρ_g = 0.4)
    noise = 1e-3 * (torch.rand(f.shape, generator=gen, dtype=f.dtype) - 0.5)
    f = f + noise * rt.geometry_channel(nx, ny, device="cpu")[None]
    p = rt.SCRTParams(omega=omega)
    want = scrt_fused.run_fused(f, p, 10)
    got, = REF.step((f,), prm, 10)
    assert got.shape == want.shape
    assert _gap(got, want) <= TOL
    # the noise broke the symmetry: the two halves of the channel differ
    rho = want.sum(0)
    assert not torch.allclose(rho, rho.flip(-1), atol=1e-9)


def test_reference_matches_the_cpp_capture_at_250_steps():
    """The case file at N = 128 (128 × 514, ω = 1): both probe columns'
    fluid rows within the capture's precision after 250 steps."""
    prm = REF.params({})
    assert (prm["nx"], prm["ny"], prm["omega"]) == (128, 514, 1.0)
    data = np.load(CAPTURE)
    f, = REF.step(REF.initial(prm), prm, 250)
    rho = f.sum(0).numpy()
    for name, col in (("col0", 0), ("colmid", 64)):
        ref = np.asarray(data[f"rho_{name}_250"], dtype=np.float64)
        assert np.abs(rho[1:-1, col] - ref[1:-1]).max() < CAPTURE_ATOL, name


@pytest.mark.parametrize("step", [1000, 2000, 3000])
def test_record_rows_follow_the_cpp_capture(step):
    """The capture's spike and bubble rows from its own ρ columns (x = nx/2
    and x = 0 of the N = 128 channel), by the reference's rule and by the
    port's ``interface_height``."""
    data = np.load(CAPTURE)
    prm = REF.params({})
    rho = np.zeros((prm["ny"], prm["nx"]))
    rho[:, 0] = data[f"rho_col0_{step}"]
    rho[:, prm["nx"] // 2] = data[f"rho_colmid_{step}"]
    want = (int(data[f"spike_{step}"]), int(data[f"bubble_{step}"]))
    fluid = REF._fluid(prm, "cpu")
    assert REF._rows(torch.from_numpy(rho), fluid, prm) == want
    assert rt.interface_height(rho, fluid.numpy(), rt.SCRTParams()) == want


def test_driver_records_and_dumps_match_reference(tmp_path):
    """``run_rayleigh_taylor_sc`` at N = 16 (16 × 66, Re 6.4: ω = 1.25),
    records every 5 steps and dumps every 10 to ``max_steps`` 20, against
    the reference stepped from its own initial state."""
    every, dump_every, steps = 5, 10, 20
    keys = {"N": 16, "Re": 6.4, "out_freq": every, "vtk_freq": dump_every}
    case = tmp_path / "case.txt"
    case.write_text((CONFIGS / "sc_rti.txt").read_text()
                    + "".join(f"\n{k} {v}" for k, v in keys.items()) + "\n")
    out = tmp_path / "out"
    apps.run_rayleigh_taylor_sc(str(case), str(out), dtype=torch.float64,
                                max_steps=steps, device="cpu")
    prm = REF.params(keys)
    state = REF.initial(prm)
    states = {}
    for it in range(0, steps, every):
        states[it] = state
        state = REF.step(state, prm, every)
    want = REF.records(states, prm)
    counts = REF.record_counts(prm, steps)
    assert counts == {"energy.dat": 4, "mass.dat": 4, "spike_bubble_position.dat": 4}
    for name, rows in want.items():
        lines = [[float(x) for x in line.split()]
                 for line in (out / name).read_text().splitlines()]
        assert len(lines) == counts[name]
        # per column, as the benchmark's check reads it: the gap over the
        # column's largest value (the file holds 16 significant digits;
        # the rows are whole multiples of dx and agree exactly)
        for col in range(len(rows[0])):
            scale = max(abs(row[col]) for row in rows.values())
            for i, row in rows.items():
                assert abs(lines[i][col] - row[col]) <= TOL * scale, (name, i, col)
    assert len(list(out.glob("*.vtk"))) == REF.dump_count(prm, steps) == 2
    for it in (0, dump_every):
        tok, counted = REF.vtk_tokens(states[it], prm, it)
        got = (out / REF.dump_name(it)).read_text().split()
        assert len(got) == len(tok) and sum(counted) > len(tok) // 2
        assert [(k, a, b) for k, (a, b, c) in enumerate(zip(got, tok, counted))
                if c and a != b] == []
