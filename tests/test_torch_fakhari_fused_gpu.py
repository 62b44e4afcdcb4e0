"""The Fakhari CUDA kernel of the port (``csrc/fakhari_step.cu``) against
the plain PyTorch path, and the physics of tests/test_fakhari.py through
the kernel, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device: the kernel has no CPU mode.  This file imports no jax, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fakhari_fused_gpu.py

Cases: the 128² bubble at the config's τ = 0.8 and at τ = 0.55, a
non-square 96 × 160 lattice, and a random state away from the bubble's
symmetry.  Tolerances: float32 over 5 steps rtol 5e-5, atol 5e-6 (those of
tests/test_pallas_fakhari.py: summation order and FMA contraction differ
from the plain path); float64 over 20 steps atol 1e-12, tight enough to
separate an indexing fault from rounding.
"""
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch.core.lattice import D2Q9
from multiphase_lbm_tpu_torch.models import fakhari as fk
from multiphase_lbm_tpu_torch.ops import fakhari_fused
from multiphase_lbm_tpu_torch.runners import coolbm
from multiphase_lbm_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

STEPS = {torch.float32: 5, torch.float64: 20}
TOL = {torch.float32: dict(rtol=5e-5, atol=5e-6),
       torch.float64: dict(rtol=0.0, atol=1e-12)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _state(case, dtype, device):
    if case == "random":
        rng = np.random.default_rng(8)
        p = fk.FakhariParams(tau=0.7, M=0.05)
        w = np.asarray(D2Q9.w)[:, None, None]
        C = rng.uniform(0.05, 0.95, (64, 80))
        h = w * C[None] * (1.0 + 0.05 * rng.standard_normal((9, 64, 80)))
        g = 0.01 * rng.standard_normal((9, 64, 80))
        u = 0.01 * rng.standard_normal((2, 64, 80))
        return p, tuple(torch.as_tensor(a, dtype=dtype, device=device)
                        for a in (h, g, u))
    tau = 0.55 if case == "tau=0.55" else 0.8
    p = fk.FakhariParams(tau=tau)
    nx, ny = (96, 160) if case == "96x160" else (128, 128)
    return p, fk.init_bubble(nx, ny, p, dtype=dtype, device=device)


def _assert_close(out, ref, tol):
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["tau=0.8", "tau=0.55", "96x160", "random"])
def test_fakhari_kernel_matches_plain(cuda_device, case, dtype):
    p, st = _state(case, dtype, cuda_device)
    n = STEPS[dtype]
    before = profiling.counter("kernel.steps.fakhari_step")
    out = fakhari_fused.run_fused(*st, p, n)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.steps.fakhari_step") == before + n
    _assert_close(out, fk.run(st, p, n), TOL[dtype])


def test_kernel_leaves_input_untouched(cuda_device):
    p, st = _state("tau=0.8", torch.float32, cuda_device)
    before = tuple(t.clone() for t in st)
    for n in (0, 1, 2, 3):
        out = fakhari_fused.run_fused(*st, p, n)
        assert all(a.data_ptr() != b.data_ptr() for a, b in zip(out, st))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(st, before))


def test_kernel_rejects_unsupported_state(cuda_device):
    p, (h, g, u) = _state("tau=0.8", torch.float32, cuda_device)
    with pytest.raises(ValueError):                  # u on another device
        fakhari_fused.run_fused(h, g, u.cpu(), p, 1)
    with pytest.raises(TypeError):                   # half precision
        fakhari_fused.run_fused(h.half(), g.half(), u.half(), p, 1)
    with pytest.raises(ValueError):                  # non-contiguous
        fakhari_fused.run_fused(h.transpose(1, 2), g.transpose(1, 2),
                                u.transpose(1, 2), p, 1)


def test_cli_runs_through_the_kernel(cuda_device, tmp_path):
    before = profiling.counter("kernel.steps.fakhari_step")
    assert coolbm.main(["Young_Laplace2D", "--f32", "--steps", "100",
                        "--outdir", str(tmp_path)]) == 0
    assert profiling.counter("kernel.steps.fakhari_step") > before
    assert (tmp_path / "sol_0000000.vtk").exists()
    assert (tmp_path / "mass.dat").exists()


def test_physics_through_the_kernel(cuda_device):
    """tests/test_fakhari.py through the kernel at 64², float64: Σφ
    conserved to 1e-12 relative, kinetic energy below 1e-5 after 500 steps,
    the bubble centred and sharp after 1000, and the Laplace jump
    p*ρ/3 inside minus outside within 35% of σ/R after 2000."""
    p = fk.FakhariParams()
    st = fk.init_bubble(64, 64, p, dtype=torch.float64, device=cuda_device)
    m0 = float(fk.total_mass(st, p))
    st = fakhari_fused.run_fused(*st, p, 500)
    e = float(fk.kinetic_energy(st))
    assert np.isfinite(e) and e < 1e-5, e
    st = fakhari_fused.run_fused(*st, p, 500)
    C = fk.phase_field(st).cpu().numpy()
    assert np.isfinite(C).all() and C[32, 32] < 0.05 and C[2, 2] > 0.95
    st = fakhari_fused.run_fused(*st, p, 1000)
    assert abs(float(fk.total_mass(st, p)) - m0) / m0 < 1e-12
    C = fk.phase_field(st).cpu().numpy()
    pphys = fk.pressure(st).cpu().numpy() * (p.rhol + C * (p.rhoh - p.rhol)) / 3.0
    dp = pphys[32, 32] - pphys[2, 2]
    expected = p.sigma / (64 / 8.0)
    assert dp > 0 and abs(dp - expected) / expected < 0.35, (dp, expected)
