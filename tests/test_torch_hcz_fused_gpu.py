"""The HCZ CUDA kernels of the port (``csrc/hcz_step.cu``,
``csrc/hcz3d_step.cu``) against the plain PyTorch path, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device: the kernels have no CPU mode.  This file imports no jax, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_hcz_fused_gpu.py

The cases are those of ``chip_smoke.py``: the RTI channel 256 × 1026 with
gravity at ω = 1.25 and at its config's ω = 1.96, the layered channel
128 × 128 with the Gx_const drive at ω = 1.25, an RTI channel with an
obstacle (mirrored reads off the walls), and the 64³ droplet at ω = 1.2.
Tolerances: float32 over 5 steps rtol 3e-5, atol 3e-6 in 2D and rtol 5e-5,
atol 5e-6 in 3D (summation order and FMA contraction differ from the plain
path); float64 over 20 steps atol 1e-12, tight enough to separate an
indexing fault from rounding.
"""
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch.models import hcz
from multiphase_lbm_tpu_torch.ops import hcz3d_fused, hcz_fused
from multiphase_lbm_tpu_torch.runners import coolbm

pytestmark = pytest.mark.gpu

STEPS = {torch.float32: 5, torch.float64: 20}
TOL2 = {torch.float32: dict(rtol=3e-5, atol=3e-6),
        torch.float64: dict(rtol=0.0, atol=1e-12)}
TOL3 = {torch.float32: dict(rtol=5e-5, atol=5e-6),
        torch.float64: dict(rtol=0.0, atol=1e-12)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _state_2d(case, dtype, device):
    if case == "layers":
        p = hcz.HCZParams(omega=1.25, kappa=0.001, Gx_const=1e-8)
        fluid = hcz.geometry_channel(128, 128, device=device)
        st = hcz.init_layers(128, 128, p, dtype=dtype, device=device)
    else:
        omega = 1.96 if case == "rti_config_omega" else 1.25
        p = hcz.HCZParams(omega=omega, gravity=-0.04 ** 2 / 256, kappa=0.01)
        fluid = hcz.geometry_channel(256, 1026, device=device)
        if case == "rti_obstacle":
            fluid[500:520, 100:130] = False
        st = hcz.init_rayleigh_taylor(256, 1026, p, dtype=dtype, device=device)
    return p, hcz.apply_geometry(st, fluid), fluid


def _assert_close(out, ref, tol):
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["rti", "rti_config_omega", "layers",
                                  "rti_obstacle"])
def test_hcz_kernel_matches_plain(cuda_device, case, dtype):
    p, st, fluid = _state_2d(case, dtype, cuda_device)
    n = STEPS[dtype]
    before = hcz_fused.LAUNCHES
    out = hcz_fused.run_fused(*st, fluid.to(torch.float32), p, n)
    torch.cuda.synchronize()
    assert hcz_fused.LAUNCHES == before + n
    _assert_close(out, hcz.run(st, fluid, p, n), TOL2[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hcz3d_kernel_matches_plain(cuda_device, dtype):
    p = hcz.HCZParams(omega=1.2, kappa=5e-4, gravity=-1e-6)
    st = hcz.init_droplet_3d(64, 64, 64, p, dtype=dtype, device=cuda_device)
    fluid = hcz.geometry_periodic_3d(64, 64, 64, device=cuda_device)
    n = STEPS[dtype]
    before = hcz3d_fused.LAUNCHES
    out = hcz3d_fused.run_fused_3d(*st, p, n)
    torch.cuda.synchronize()
    assert hcz3d_fused.LAUNCHES == before + n
    ref = hcz.run(st, fluid, p, n, lattice=hcz.D3Q19, three_d=True)
    _assert_close(out, ref, TOL3[dtype])


def test_kernels_leave_input_untouched(cuda_device):
    p, (f, g), fluid = _state_2d("rti", torch.float32, cuda_device)
    before = (f.clone(), g.clone())
    for n in (0, 1, 2, 3):
        out = hcz_fused.run_fused(f, g, fluid.to(torch.float32), p, n)
        assert out[0].data_ptr() != f.data_ptr()
    p3 = hcz.HCZParams(omega=1.2)
    f3, g3 = hcz.init_droplet_3d(16, 16, 16, p3, device=cuda_device)
    before3 = (f3.clone(), g3.clone())
    for n in (0, 1, 2, 3):
        out = hcz3d_fused.run_fused_3d(f3, g3, p3, n)
        assert out[1].data_ptr() != g3.data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(f, before[0]) and torch.equal(g, before[1])
    assert torch.equal(f3, before3[0]) and torch.equal(g3, before3[1])


def test_kernels_reject_unsupported_state(cuda_device):
    p, (f, g), fluid = _state_2d("layers", torch.float32, cuda_device)
    fl = fluid.to(torch.float32)
    with pytest.raises(ValueError):                  # mask on another device
        hcz_fused.run_fused(f, g, fl.cpu(), p, 1)
    with pytest.raises(ValueError):                  # g on another device
        hcz_fused.run_fused(f, g.cpu(), fl, p, 1)
    with pytest.raises(TypeError):                   # half precision
        hcz_fused.run_fused(f.half(), g.half(), fl, p, 1)
    with pytest.raises(ValueError):                  # non-contiguous
        hcz_fused.run_fused(f.transpose(1, 2), g.transpose(1, 2),
                            fl.t(), p, 1)
    with pytest.raises(ValueError):                  # a 2D state in 3D
        hcz3d_fused.run_fused_3d(f, g, p, 1)


def test_cli_runs_through_the_kernels(cuda_device, tmp_path):
    before2, before3 = hcz_fused.LAUNCHES, hcz3d_fused.LAUNCHES
    assert coolbm.main(["rayleighTaylor2D", "--f32", "--steps", "64",
                        "--outdir", str(tmp_path / "rt")]) == 0
    assert coolbm.main(["laplace3D", "--f32", "--steps", "20",
                        "--outdir", str(tmp_path / "l3")]) == 0
    assert hcz_fused.LAUNCHES > before2 and hcz3d_fused.LAUNCHES > before3
    assert (tmp_path / "rt" / "spike_bubble_position.dat").exists()
    assert (tmp_path / "l3" / "sol_0000000.vtk").exists()


def test_laplace_law_through_the_3d_kernel(cuda_device):
    """The 3D Young–Laplace gate of tests/test_hcz.py, through the kernel in
    float64: droplets of radius 6 and 9 in a 32³ box at κ = 5e-4 must give
    the same surface tension σ = ΔP·R/2 within 2% after 1200 steps."""
    p = hcz.HCZParams(kappa=5e-4, rho_l=0.12, rho_g=0.04)
    n = 32
    fluid = hcz.geometry_periodic_3d(n, n, n, device=cuda_device)
    sigmas = []
    for R in (6.0, 9.0):
        st = hcz.init_droplet_3d(n, n, n, p, radius=R, dtype=torch.float64,
                                 device=cuda_device)
        st = hcz3d_fused.run_fused_3d(*st, p, 1200)
        P = hcz.macro_3d(*st, fluid, p)[3].cpu().numpy()
        c = n // 2
        dP = P[c, c, c] - 0.5 * (P[1, 1, 1] + P[2, 2, 2])
        phi = hcz.order_parameter(st[0]).cpu().numpy()
        vol = float(((phi - phi.min()) / (phi.max() - phi.min()) > 0.5).sum())
        r_meas = (3.0 * vol / (4.0 * np.pi)) ** (1.0 / 3.0)
        assert dP > 0.0
        sigmas.append(dP * r_meas / 2.0)
    assert abs(sigmas[0] - sigmas[1]) / sigmas[1] < 0.02, sigmas
