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

The record kernel (``scrt_fused.record``) against the plain record of the
same state (``kinetic_energy``, Σρ over the fluid, ``interface_height``):
those channels and the benchmark cell's 2048 × 8194 float32 channel after
300 steps; energy and mass rtol 1e-5 in float32 and 1e-12 in float64; the
rows exactly those of ρ summed in the kernel's order, and those of
``density``'s sum except where ρ ties the cut within 4 ulp; two launches a
record, and the same bits twice.
"""
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch.models import shan_chen_rt as rt
from multiphase_lbm_tpu_torch.ops import scrt_fused
from multiphase_lbm_tpu_torch.runners import coolbm
from multiphase_lbm_tpu_torch.runners.common import Driver
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


RECORD_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _check_record(f, fluid, p):
    """Hold ``record`` of ``f`` to the plain record; returns it."""
    nx = f.shape[2]
    names = ("kernel.steps.scrt_record", "kernel.launches.scrt_record")
    before = [profiling.counter(n) for n in names]
    got = scrt_fused.record(f, fluid, p).cpu()
    assert [profiling.counter(n) - b for n, b in zip(names, before)] == [1, 2]
    rho = rt.density(f)
    e = float(rt.kinetic_energy(f, fluid, p))
    m = float((rho * fluid).sum())
    assert e > 0.0
    tol = RECORD_RTOL[f.dtype]
    np.testing.assert_allclose(got[:2].numpy(), [e, m], rtol=tol, atol=0.0)
    fl = fluid.cpu().numpy()
    # the rows: interface_height's rule on ρ summed as the kernel sums it
    # (f_0 + f_1 + ... + f_8, in that order), exactly
    rho_k = f[0].clone()
    for k in range(1, 9):
        rho_k += f[k]
    rows = rt.interface_height(rho_k.cpu().numpy(), fl, p)
    assert (got[2].item(), got[3].item()) == rows
    # density sums in another order; a row may differ from its rows only
    # where ρ ties the cut to rounding
    rho_p = rho.cpu().numpy()
    cut = rho_p.dtype.type(0.5 * (p.rhol + p.rhog))
    for x, a, b in zip((nx // 2, 0), rows, rt.interface_height(rho_p, fl, p)):
        if a != b:
            r = rho_p[int(max(a, b)), x]
            assert abs(r - cut) <= 4 * np.spacing(cut), (x, a, b, r)
    assert torch.equal(scrt_fused.record(f, fluid, p).cpu(), got)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(128, 514), (7, 3), (5, 4)])
@pytest.mark.parametrize("omega", [1.0, 1.25])
def test_record_matches_plain(cuda_device, omega, shape, dtype):
    p, f, fluid = _state(*shape, omega, dtype, cuda_device)
    _check_record(f, fluid, p)
    _check_record(scrt_fused.run_fused(f, p, STEPS[dtype]), fluid, p)


def test_record_matches_plain_on_the_benchmark_channel(cuda_device):
    """The cell's 2048 × 8194 float32 channel (Re 450, the middle of its
    drawn range; gravity −u_lb²/N) after 300 kernel steps, read as the
    driver reads it: 32 bytes."""
    from multiphase_lbm_tpu_torch.io.config import lb_parameters
    omega = lb_parameters(0.04, 2048, 450.0)[1]
    p = rt.SCRTParams(omega=omega, gravity=-0.04 ** 2 / 2048)
    fluid = rt.geometry_channel(2048, 8194, device=cuda_device)
    f = rt.init_interface(2048, 8194, p, dtype=torch.float32,
                          device=cuda_device) * fluid[None]
    f = scrt_fused.run_fused(f, p, 300)
    got = _check_record(f, fluid, p)
    before = profiling.counter("d2h_bytes")
    assert Driver.numpy(scrt_fused.record(f, fluid, p)).tolist() == \
        got.tolist()
    assert profiling.counter("d2h_bytes") - before == 32
