"""The CUDA kernel of the port (``csrc/sc_step.cu``) against the plain
PyTorch path, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device: the kernel has no CPU mode.  This file imports no jax, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sc_fused_gpu.py

Cases run at ω = 1.25 (τ = 0.8), where the rank-2 MRT term is live: the
periodic droplet, the droplet on a wall with an obstacle, and the
constant-G layered channel with a per-node force (gx_u, gy_u ≠ 0).
Tolerances: float32 rtol 2e-5, atol 2e-6 over 5 steps (summation order and
FMA contraction differ from the plain path); float64 atol 1e-12 over 20
steps, tight enough to separate an indexing fault from rounding.
"""
import dataclasses

import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch.models import shan_chen as sc
from multiphase_lbm_tpu_torch.ops import sc_fused
from multiphase_lbm_tpu_torch.runners import coolbm

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-6),
       torch.float64: dict(rtol=0.0, atol=1e-12)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _layered(p):
    """``p`` as the layered channel's constant-G parameters, with its
    per-node force."""
    p = dataclasses.replace(p, TT0=0.95, rhol=0.21, rhog=0.067, rho_w=0.067,
                            psi_mode="const_g", G=-1.0, gx_u=1e-6,
                            gy_u=-3e-7)
    return dataclasses.replace(p, p_shift=sc.compute_p_shift(p))


def _state(geometry, dtype, device, p):
    nx, ny = (256, 256) if geometry == "periodic" else (256, 128)
    if geometry == "layers":
        f = sc.init_layers(nx, ny, p, dtype=dtype, device=device)
        fluid = sc.geometry_channel_walls(nx, ny, device=device)
        return sc.apply_geometry(f, fluid), fluid
    if geometry == "periodic":
        f = sc.init_droplet(nx, ny, p, radius=32.0, dtype=dtype, device=device)
        fluid = sc.geometry_periodic(nx, ny, device=device)
    else:
        f = sc.init_droplet(nx, ny, p, radius=32.0, center=(nx / 2, 5.0),
                            dtype=dtype, device=device)
        fluid = sc.geometry_channel_walls(nx, ny, device=device)
        fluid[40:48, 100:120] = False                # an obstacle
        f = sc.apply_geometry(f, fluid)
    return f, fluid


@pytest.mark.parametrize("dtype,steps", [(torch.float32, 5), (torch.float64, 20)])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("collision", ["bgk", "mrt"])
@pytest.mark.parametrize("geometry", ["periodic", "walls", "layers"])
def test_kernel_matches_plain(cuda_device, geometry, collision, center, dtype,
                              steps):
    p = sc.SCParams(collision=collision, omega=1.25, rho_w=0.2,
                    wall_psi_center_branch=center, gravity=1e-5, gx=-2e-5)
    if geometry == "layers":
        p = _layered(p)
    f, fluid = _state(geometry, dtype, cuda_device, p)
    before = sc_fused.LAUNCHES
    out = sc_fused.run_fused(f, fluid.to(torch.float32), p, steps,
                             periodic=geometry == "periodic")
    torch.cuda.synchronize()
    assert sc_fused.LAUNCHES == before + steps
    ref = sc.run(f, fluid, p, steps)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL[dtype])


def test_kernel_leaves_input_untouched(cuda_device):
    p = sc.SCParams(collision="mrt", omega=1.25)
    f, fluid = _state("periodic", torch.float32, cuda_device, p)
    before = f.clone()
    for n in (0, 1, 2, 3):
        out = sc_fused.run_fused(f, fluid.to(torch.float32), p, n, periodic=True)
        assert out.data_ptr() != f.data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(f, before)


def test_kernel_rejects_unsupported_params_on_cuda(cuda_device):
    p = sc.SCParams(psi_mode="bogus")
    f, fluid = _state("periodic", torch.float32, cuda_device, sc.SCParams())
    with pytest.raises(NotImplementedError, match="bogus"):
        sc_fused.run_fused(f, fluid.to(torch.float32), p, 1)
    with pytest.raises(ValueError):
        sc_fused.run_fused(f, fluid.to(torch.float32).cpu(), sc.SCParams(), 1)


def test_cli_runs_through_the_kernel(cuda_device, tmp_path):
    before = sc_fused.LAUNCHES
    assert coolbm.main(["contactAngle2D", "--f32", "--steps", "40",
                        "--outdir", str(tmp_path), "--device", "cuda"]) == 0
    assert sc_fused.LAUNCHES > before
    assert (tmp_path / "sol_0000000.vtk").exists()
    assert (tmp_path / "contact_angle.dat").exists()


def test_layered_cli_runs_through_the_kernel(cuda_device, tmp_path):
    before = sc_fused.LAUNCHES
    assert coolbm.main(["twoLayeredFlow2D_sc", "--steps", "40",
                        "--outdir", str(tmp_path), "--device", "cuda"]) == 0
    assert sc_fused.LAUNCHES > before
    for name in ("sol_0000000.vtk", "energy.dat", "mass.dat"):
        assert (tmp_path / name).exists()
