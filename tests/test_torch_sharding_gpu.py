"""The halo-in entries of the port's kernel wrappers and the decomposed
steps built on them, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device: the kernels have no CPU mode.  This file imports no jax, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sharding_gpu.py

* Each halo-in entry (``step_fused_halo``: the family's kernel launched
  ``nsub`` times on a halo-extended slab) against its plain version
  (``step_halo_plain``: the plain step on the same slab, cropped alike),
  float32 over 5 sub-steps at the family's kernel tolerance (SC, SC-RT and
  combustion rtol 2e-5, atol 2e-6; HCZ 2D 3e-5, 3e-6; HCZ 3D and Fakhari
  5e-5, 5e-6: summation order and FMA contraction differ) and float64 over
  20 sub-steps (atol 1e-12), at ω ≠ 1.  Combustion (the kernel's slab mode:
  rows of the 128 × 256 channel whose own rows hold both wall rows and the
  y wrap, over the cells where the model defines each field) also at 1 and
  2 sub-steps in float32, each with all four populations, flow only and in
  the lid cavity.
* Each decomposed path (``parallel/sharding.make_fused_*_step``) against
  the single-lattice kernel run of as many steps
  (``validation/multichip_check`` at its default sizes, and the combustion
  channel also at full width, 840 × 160 on 4 y shards): the same kernel
  does the same per-cell arithmetic, so the gate is 1e-6 and 0 is
  expected.
"""
import pytest
import torch

from multiphase_lbm_tpu_torch.ops import combustion_fused
from multiphase_lbm_tpu_torch.validation import multichip_check

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,nsub", [(torch.float32, 5), (torch.float64, 20)])
@pytest.mark.parametrize("family", list(multichip_check.HALO_ENTRIES))
def test_halo_kernel_matches_plain(cuda_device, family, dtype, nsub):
    res = multichip_check.check_halo_entry(family, dtype, nsub, cuda_device)
    torch.cuda.synchronize()
    assert res["launched"] == nsub and res["launched_main"] == 0
    assert res["ok"], res


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("variant,dtype,nsub", [
    (v, d, n) for v in ("konv", "flow", "cavity")
    for d, n in ((F32, 1), (F32, 2), (F32, 5), (F64, 20))])
def test_combustion_halo_kernel_matches_plain(cuda_device, variant, dtype,
                                              nsub):
    res = multichip_check.check_halo_entry("combustion", dtype, nsub,
                                           cuda_device, variant)
    torch.cuda.synchronize()
    assert res["launched"] == nsub and res["launched_main"] == 0
    assert res["ok"], res


def test_halo_kernel_leaves_input_untouched(cuda_device):
    _, kernel, _, args = multichip_check.halo_entry_case(
        "sc", torch.float32, 3, cuda_device)
    before = args[0].clone()
    kernel(*args, nsub=3)
    torch.cuda.synchronize()
    assert torch.equal(args[0], before)


@pytest.mark.parametrize("name", sorted(multichip_check.CASES))
def test_decomposed_path_matches_single_lattice_kernel(cuda_device, name):
    res = multichip_check.check(name, device="cuda")
    assert res["ok"], multichip_check.summary(res)


def test_combustion_full_width_matches_single_lattice_kernel(cuda_device):
    """840 × 160 on 4 y shards, nsub 2, 100 steps: 50 calls, each launching
    the kernel for 2 steps on every shard's slab."""
    before = combustion_fused.HALO_LAUNCHES
    res = multichip_check.check("combustion", device="cuda", full=True)
    assert res["ok"], multichip_check.summary(res)
    assert combustion_fused.HALO_LAUNCHES - before == 50 * 4 * 2
