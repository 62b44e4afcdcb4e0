"""The pulsatile-vessel CUDA kernel of the port (``csrc/pulsatile_step.cu``)
against the plain PyTorch path, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device: the kernel has no CPU mode.  This file imports no jax, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu -s tests/test_torch_pulsatile_fused_gpu.py

The case is the reference's own, N = 64 (621 × 64).  Tolerances: one step
from a 4-step warm state, float32 within those of
tests/test_pallas_pulsatile_full.py (g, P, U 5e-7; yr 5e-5; F 1e-4) and
float64 at atol 1e-12 with identical fluid maps; 27 float64 steps at atol
1e-10 on every field.  Steps 0 and 1 from ``initialize`` are
order-dependent reseed steps (the plain path fills them sequentially, the
kernel densely, by design), so the 27-step window is steps 2 to 28, which
have none.  Over 12 float32 steps the trajectories are compared by the
statistics of the Pallas test (the model is chaotic in float32).  At the
bench's N = 384 (3,821 × 384, from ``bench.pulsatile_warm_state``) one
step in float32 and in float64 equals the plain path bit for bit; one
call of n steps equals n calls of one step; and a call launches
``LAUNCHES_PER_STEP`` kernels a step (counted by ``torch.profiler``).
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch import bench
from multiphase_lbm_tpu_torch.models import pulsatile as pm
from multiphase_lbm_tpu_torch.ops import pulsatile_fused as pf
from multiphase_lbm_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

N = 64
P = pm.PulsatileParams(nx=1 + 10 * (N - 2), ny=N)
F32_TOL = {"g_coll": 5e-7, "g_stream": 5e-7, "P": 5e-7, "Ux": 5e-7,
           "Uy": 5e-7, "F": 1e-4, "yr1": 5e-5, "yr2": 5e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _warm(dtype, device, steps):
    return pm.run(pm.initialize(P, dtype, device=device), 0, P, steps)


def _max_err(a, b, name):
    return float((getattr(a, name).double() - getattr(b, name).double())
                 .abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_step_matches_plain(cuda_device, dtype):
    st = _warm(dtype, cuda_device, 4)
    ref, (n_dep, n_cells) = pm.run_with_diag(st, 4, P, 1)
    before = profiling.counter("kernel.steps.pulsatile_step")
    out, diag = pf.run_fused_full(st, 4, P, 1)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.steps.pulsatile_step") == before + 1
    assert out.g_stream.dtype == dtype
    assert int(diag[0]) == 0 and n_dep == 0
    assert int(diag[1]) == n_cells > 0
    assert torch.equal(out.fluid, ref.fluid)
    for name, tol in F32_TOL.items():
        err = _max_err(out, ref, name)
        assert err < (tol if dtype == torch.float32 else 1e-12), (name, err)


def test_27_steps_float64_match_plain(cuda_device):
    st = _warm(torch.float64, cuda_device, 2)
    ref, (n_dep, _) = pm.run_with_diag(st, 2, P, 27)
    out, diag = pf.run_fused_full(st, 2, P, 27)
    assert n_dep == 0 and int(diag[0]) == 0
    assert torch.equal(out.fluid, ref.fluid)
    for name in F32_TOL:
        assert _max_err(out, ref, name) < 1e-10, name


def test_12_steps_float32_statistics(cuda_device):
    st = _warm(torch.float32, cuda_device, 4)
    ref = pm.run(st, 4, P, 12)
    out, _ = pf.run_fused_full(st, 4, P, 12)
    for name in ("yr1", "yr2"):
        d = (getattr(ref, name) - getattr(out, name)).abs().cpu().numpy()
        assert np.median(d) < 0.05 and d.max() < 1.0, (name, d.max())
    m = ref.fluid & out.fluid
    assert float((ref.P - out.P).abs()[m].mean()) < 2e-4


def test_kernel_leaves_input_untouched(cuda_device):
    st = _warm(torch.float32, cuda_device, 4)
    before = [t.clone() for t in st]
    for n in (0, 1, 2, 3):
        out, _ = pf.run_fused_full(st, 4, P, n)
        assert out.g_stream.data_ptr() != st.g_stream.data_ptr()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(st, before))


@pytest.mark.parametrize("change", [
    dict(momentum_quirk=False), dict(pingpong_quirk=False),
    dict(mrt_basis_quirk=False), dict(zou_he_corner_closure=True),
    dict(collision="bgk"), dict(deformable=False)])
def test_kernel_refuses_unsupported_modes(cuda_device, change):
    st = pm.initialize(P, torch.float32, device=cuda_device)
    with pytest.raises(NotImplementedError):
        pf.run_fused_full(st, 0, dataclasses.replace(P, **change), 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_step_at_the_bench_size_is_bit_identical(cuda_device, dtype):
    p, st, t = bench.pulsatile_warm_state(384, cuda_device)
    if dtype == torch.float64:
        st = st._replace(**{k: getattr(st, k).double() for k in
                            ("g_coll", "g_stream", "yr1", "yr2", "P", "Ux",
                             "Uy")})
        F = pm.fobj_from_walls(st.yr1, st.yr2, p)
        st = st._replace(F=F, fluid=pm.flags_from_fobj(F, p))
    ref, counts = pm.run_with_diag(st, t, p, 1)
    out, diag = pf.run_fused_full(st, t, p, 1)
    assert diag.tolist() == list(counts)
    assert torch.equal(out.fluid, ref.fluid)
    for name in F32_TOL:
        assert _max_err(out, ref, name) == 0.0, name


@pytest.mark.parametrize("n", [5, 9])
def test_one_call_of_n_steps_equals_n_calls(cuda_device, n):
    """9 steps replay the kernel's captured graph of two steps (calls of 8
    steps or more), 5 do not; from t0 = t_start + 40 the inlet pressure
    changes every step."""
    st = _warm(torch.float64, cuda_device, 4)
    t0 = P.t_start + 40
    whole, diag = pf.run_fused_full(st, t0, P, n)
    part, total = st, torch.zeros(2, dtype=torch.int64)
    for i in range(n):
        part, d = pf.run_fused_full(part, t0 + i, P, 1)
        total += d
    assert diag.tolist() == total.tolist()
    assert all(torch.equal(a, b) for a, b in zip(whole, part))


def test_launches_a_step(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    st = _warm(torch.float32, cuda_device, 4)
    pf.run_fused_full(st, 4, P, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pf.run_fused_full(st, 4, P, 3)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type != DeviceType.CPU]
    ours = [n for n in names
            if re.search(r"(links|tile|tail|reseed_scatter)_kernel", n)]
    assert len(ours) == 3 * pf.LAUNCHES_PER_STEP == 15, names
