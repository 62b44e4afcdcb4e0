"""The SC Rayleigh–Taylor CUDA kernel of the port (``csrc/scrt_step.cu``)
against the plain PyTorch path, and against the capture of the C++
reference, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device: the kernel has no CPU mode.  This file imports no jax, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu -s tests/test_torch_scrt_fused_gpu.py

Cases: the 128 × 514 channel at the config's ω = 1 and at ω = 1.25 (at
ω = 1 the (1 − ω)·f term vanishes), and the narrowest channels (3 and 4
rows, where the mirrored read lands on the other wall).  Tolerances:
float32 over 5 steps rtol 2e-5, atol 2e-6 (those of
tests/test_pallas_scrt.py); float64 over 20 steps atol 1e-12.
"""
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch.models import shan_chen_rt as rt
from multiphase_lbm_tpu_torch.ops import scrt_fused
from multiphase_lbm_tpu_torch.runners import coolbm
from multiphase_lbm_tpu_torch.utils import profiling
from multiphase_lbm_tpu_torch.validation import scrt_reference

pytestmark = pytest.mark.gpu

STEPS = {torch.float32: 5, torch.float64: 20}
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-6),
       torch.float64: dict(rtol=0.0, atol=1e-12)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _state(nx, ny, omega, dtype, device):
    p = rt.SCRTParams(omega=omega)
    fluid = rt.geometry_channel(nx, ny, device=device)
    f = rt.init_interface(nx, ny, p, dtype=dtype, device=device) * fluid[None]
    return p, f, fluid


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(128, 514), (7, 3), (5, 4)])
@pytest.mark.parametrize("omega", [1.0, 1.25])
def test_scrt_kernel_matches_plain(cuda_device, omega, shape, dtype):
    p, f, fluid = _state(*shape, omega, dtype, cuda_device)
    n = STEPS[dtype]
    before = profiling.counter("kernel.steps.scrt_step")
    out = scrt_fused.run_fused(f, p, n)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.steps.scrt_step") == before + n
    assert out.dtype == dtype
    assert bool((out[:, 0] == 0).all()) and bool((out[:, -1] == 0).all())
    np.testing.assert_allclose(out.cpu().numpy(),
                               rt.run(f, fluid, p, n).cpu().numpy(),
                               **TOL[dtype])


def test_kernel_leaves_input_untouched(cuda_device):
    p, f, _ = _state(128, 514, 1.25, torch.float32, cuda_device)
    before = f.clone()
    for n in (0, 1, 2, 3):
        assert scrt_fused.run_fused(f, p, n).data_ptr() != f.data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(f, before)


def test_kernel_rejects_unsupported_state(cuda_device):
    p, f, _ = _state(16, 66, 1.0, torch.float32, cuda_device)
    with pytest.raises(TypeError):                   # half precision
        scrt_fused.run_fused(f.half(), p, 1)
    with pytest.raises(ValueError):                  # non-contiguous
        scrt_fused.run_fused(f.transpose(1, 2), p, 1)
    with pytest.raises(ValueError):                  # no fluid row
        scrt_fused.run_fused(f[:, :2].contiguous(), p, 1)


def test_cli_runs_through_the_kernel(cuda_device, tmp_path):
    before = profiling.counter("kernel.steps.scrt_step")
    assert coolbm.main(["RayleighTaylor2D_sc", "--f32", "--steps", "200",
                        "--outdir", str(tmp_path)]) == 0
    assert profiling.counter("kernel.steps.scrt_step") > before
    assert (tmp_path / "spike_bubble_position.dat").exists()


def test_kernel_matches_the_cpp_capture(cuda_device):
    """The config at N = 128 through the kernel in float64: both probe
    columns within 5e-5 of the C++ capture at steps 250 and 1000; steps
    2000 and 3000 are printed, not gated."""
    rows = scrt_reference.compare(device=cuda_device)
    for step, row in rows.items():
        print(f"[capture] step {step}: {row}")
    for step in scrt_reference.GATED_STEPS:
        assert rows[step]["col0"] < scrt_reference.ATOL, rows[step]
        assert rows[step]["colmid"] < scrt_reference.ATOL, rows[step]
