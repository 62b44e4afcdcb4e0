"""The benchmark's plain reference of the Fakhari bubble
(``benchmark/configs/fakhari_bubble_ref.py``) against the port, on the CPU.

The reference is written apart from the port, from the reference solver's
equations; these tests hold the two together in float64, each within 1e-12
of the field's or the column's largest value.  Both sum in another order,
and inside the bubble 1/ρ is a thousand, which lifts the velocity's
round-off to about 1e-13 of its largest value after 10 steps; the
populations agree to a few 1e-15.  The step is compared against the port's
plain path (``fakhari_fused.run_fused`` on CPU tensors) on a 24 × 32
lattice, so that an x/y swap shows, from the bubble with seeded noise on h,
g and u, so that every term of the force and of the stale-u update is
exercised away from symmetry.  The driver (``run_young_laplace2d``) is
compared from the reference's own initial state: its ``energy.dat`` and
``mass.dat``, its line counts, and its ``sol_*.vtk`` dumps.
"""
import importlib.util
from pathlib import Path

import torch

from multiphase_lbm_tpu_torch.models import fakhari as fk
from multiphase_lbm_tpu_torch.ops import fakhari_fused
from multiphase_lbm_tpu_torch.runners import apps

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "benchmark" / "configs"
spec = importlib.util.spec_from_file_location("bench_fakhari_bubble_ref",
                                              CONFIGS / "fakhari_bubble_ref.py")
REF = importlib.util.module_from_spec(spec)
spec.loader.exec_module(REF)
TOL = 1e-12


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_reference_step_matches_plain_path():
    ny, nx = 24, 32
    prm = dict(REF.params({}), nx=nx, ny=ny, cells=nx * ny)
    p = fk.FakhariParams()
    h, g, u = fk.init_bubble(nx, ny, p, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(22)

    def noise(t, scale):
        return t + scale * (torch.rand(t.shape, generator=gen, dtype=t.dtype) - 0.5)
    # at most 4.5e-5 on φ, so ρ stays above ρ_L / 2 in the bubble
    state = (noise(h, 1e-5), noise(g, 1e-5), noise(u, 1e-4))
    want = fakhari_fused.run_fused(*state, p, 10)
    got = REF.step(state, prm, 10)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _gap(a, b) <= TOL
    # the noise broke the symmetry: the two halves of the lattice differ
    assert not torch.allclose(want[2], want[2].flip(-1), atol=1e-9)


def test_driver_records_and_dumps_match_reference(tmp_path):
    """``run_young_laplace2d`` at 24², records and dumps every 5 steps to
    ``max_steps`` 20 inclusive, against the reference stepped from its own
    initial state."""
    N, every, steps = 24, 5, 20
    case = tmp_path / "case.txt"
    case.write_text((CONFIGS / "fakhari_bubble.txt").read_text()
                    + f"\nN {N}\nout_freq {every}\nvtk_freq {every}\n")
    out = tmp_path / "out"
    apps.run_young_laplace2d(str(case), str(out), dtype=torch.float64,
                             max_steps=steps, device="cpu")
    prm = REF.params({"N": N, "out_freq": every, "vtk_freq": every})
    state = REF.initial(prm)
    states = {}
    for it in range(0, steps + 1, every):
        states[it] = state
        state = REF.step(state, prm, every)
    want = REF.records(states, prm)
    counts = REF.record_counts(prm, steps)
    assert counts == {"energy.dat": 5, "mass.dat": 5}
    for name, rows in want.items():
        lines = [[float(x) for x in line.split()]
                 for line in (out / name).read_text().splitlines()]
        assert len(lines) == counts[name]
        # per column, as the benchmark's check reads it: the gap over the
        # column's largest value (the file holds 16 significant digits)
        for col in range(2):
            scale = max(abs(row[col]) for row in rows.values())
            for i, row in rows.items():
                assert abs(lines[i][col] - row[col]) <= TOL * scale
    assert len(list(out.glob("*.vtk"))) == REF.dump_count(prm, steps) == 5
    for it, st in states.items():
        tok, counted = REF.vtk_tokens(st, prm, it)
        got = (out / REF.dump_name(it)).read_text().split()
        assert len(got) == len(tok) and sum(counted) > len(tok) // 2
        assert [(k, a, b) for k, (a, b, c) in enumerate(zip(got, tok, counted))
                if c and a != b] == []
