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
statistics of the Pallas test (the model is chaotic in float32).
"""
import dataclasses

import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch.models import pulsatile as pm
from multiphase_lbm_tpu_torch.ops import pulsatile_fused as pf

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
    before = pf.LAUNCHES
    out, diag = pf.run_fused_full(st, 4, P, 1)
    torch.cuda.synchronize()
    assert pf.LAUNCHES == before + 1
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
