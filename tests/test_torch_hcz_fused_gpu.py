"""The HCZ CUDA kernels of the port (``csrc/hcz_step.cu``,
``csrc/hcz3d_step.cu``) against the plain PyTorch path, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device: the kernels have no CPU mode.  This file imports no jax, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_hcz_fused_gpu.py

The cases are those of ``chip_smoke.py``: the RTI channel 256 × 1026 with
gravity at ω = 1.25 and at its config's ω = 1.96, the layered channel
128 × 128 with the Gx_const drive at ω = 1.25, an RTI channel with an
obstacle (mirrored reads off the walls), lattices that are not multiples
of the 2D kernel's 32 × 8 tile and reach past its 2-cell halo (channels of
45 × 37 and 3 × 5, periodic 7 × 2, nx × ny), an obstacle across its tile
edges, and the D3Q19 droplet at ω = 1.2 in a 64³ box, in a box that is not
a multiple of the 3D kernel's 32 × 8 tile or 16-plane chunk (37 × 11 × 9)
and in one thinner in z than its 7-plane φ window (33 × 9 × 3); the 3D
entries make one C call a call.
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
from multiphase_lbm_tpu_torch.utils import profiling

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
    small = {"channel_45x37": (45, 37), "channel_3x5": (3, 5),
             "periodic_7x2": (7, 2), "obstacle_tile_edges": (45, 37)}
    if case in small:
        nx, ny = small[case]
        p = hcz.HCZParams(omega=1.25, gravity=-1e-5, kappa=0.01)
        fluid = hcz.geometry_channel(nx, ny, device=device)
        if case == "periodic_7x2":
            fluid[:] = True
        if case == "obstacle_tile_edges":    # crosses x = 32 and y = 8
            fluid[5:12, 28:36] = False
        st = hcz.init_rayleigh_taylor(nx, ny, p, dtype=dtype, device=device)
    elif case == "layers":
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
                                  "rti_obstacle", "channel_45x37",
                                  "channel_3x5", "periodic_7x2",
                                  "obstacle_tile_edges"])
def test_hcz_kernel_matches_plain(cuda_device, case, dtype):
    p, st, fluid = _state_2d(case, dtype, cuda_device)
    n = STEPS[dtype]
    before = profiling.counter("kernel.steps.hcz_step")
    out = hcz_fused.run_fused(*st, fluid.to(torch.float32), p, n)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.steps.hcz_step") == before + n
    _assert_close(out, hcz.run(st, fluid, p, n), TOL2[dtype])


def test_launches_count_steps(cuda_device):
    """One launch a step: ``kernel.steps.hcz_step`` and
    ``kernel.launches.hcz_step`` grow by ``n_steps`` (0 for 0 steps), their
    ``.halo`` counters by ``nsub`` for the halo entry, each from one C
    call."""
    p, (f, g), fluid = _state_2d("channel_45x37", torch.float32, cuda_device)
    fl = fluid.to(torch.float32)
    names = [f"kernel.{what}.hcz_step{tail}" for tail in ("", ".halo")
             for what in ("steps", "launches")]
    for n in (0, 1, 2, 7):
        before = [profiling.counter(name) for name in names]
        hcz_fused.run_fused(f, g, fl, p, n)
        assert [profiling.counter(name) for name in names] == [
            before[0] + n, before[1] + n, before[2], before[3]]
    for nsub in (1, 2):
        before = [profiling.counter(name) for name in names]
        hcz_fused.step_fused_halo(f, g, fl, p, nsub)
        assert [profiling.counter(name) for name in names] == [
            before[0], before[1], before[2] + nsub, before[3] + nsub]
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("box", [(64, 64, 64), (37, 11, 9), (33, 9, 3)])
def test_hcz3d_kernel_matches_plain(cuda_device, box, dtype):
    """The 64³ droplet, a box that is not a multiple of the 32 × 8 tile or
    the 16-plane chunk, and one thinner in z than the 7-plane φ window
    (nx × ny × nz)."""
    p = hcz.HCZParams(omega=1.2, kappa=5e-4, gravity=-1e-6)
    radius = None if box[0] == 64 else min(box) / 3.0
    st = hcz.init_droplet_3d(*box, p, radius=radius, dtype=dtype,
                             device=cuda_device)
    fluid = hcz.geometry_periodic_3d(*box, device=cuda_device)
    n = STEPS[dtype]
    before = profiling.counter("kernel.steps.hcz3d_step")
    out = hcz3d_fused.run_fused_3d(*st, p, n)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.steps.hcz3d_step") == before + n
    ref = hcz.run(st, fluid, p, n, lattice=hcz.D3Q19, three_d=True)
    _assert_close(out, ref, TOL3[dtype])


class _CountingLib:
    """The kernel library, counting the calls of its C entries."""

    def __init__(self, lib):
        self.lib, self.calls = lib, 0

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.startswith("hcz3d_step"):
            return fn

        def call(*args):
            self.calls += 1
            return fn(*args)
        return call


def test_hcz3d_one_ctypes_call_a_call(cuda_device, monkeypatch):
    """A call of n steps is one C call and adds n to
    ``kernel.steps.hcz3d_step`` and 2n to ``kernel.launches.hcz3d_step`` (0
    and no call for 0 steps); the halo entry adds nsub to
    ``kernel.steps.hcz3d_step.halo``."""
    from multiphase_lbm_tpu_torch.ops import _build

    counting = _CountingLib(_build.load())
    monkeypatch.setattr(_build, "load", lambda: counting)
    p = hcz.HCZParams(omega=1.2)
    f, g = hcz.init_droplet_3d(37, 11, 9, p, radius=3.0, device=cuda_device)
    steps, launches = "kernel.steps.hcz3d_step", "kernel.launches.hcz3d_step"
    for n in (0, 1, 2, 7):
        before, calls = profiling.counter(steps), counting.calls
        launched = profiling.counter(launches)
        hcz3d_fused.run_fused_3d(f, g, p, n)
        assert profiling.counter(steps) == before + n
        assert profiling.counter(launches) == launched + 2 * n
        assert counting.calls == calls + (n > 0)
    f2, g2 = hcz.init_droplet_3d(16, 16, 40, p, device=cuda_device)
    for nsub in (1, 2):
        before, calls = profiling.counter(steps + ".halo"), counting.calls
        hcz3d_fused.step_fused_halo_3d(f2, g2, p, nsub)
        assert profiling.counter(steps + ".halo") == before + nsub
        assert counting.calls == calls + 1
    torch.cuda.synchronize()


def test_hcz3d_refuses_boxes_past_32_bit_indices(cuda_device):
    """19·nz·ny·nx >= 2^31 raises before anything is allocated or
    launched."""
    p = hcz.HCZParams()
    f = torch.empty((19, 1024, 1024, 108), device=cuda_device)
    allocated = torch.cuda.memory_allocated()
    before = profiling.counter("kernel.steps.hcz3d_step")
    with pytest.raises(ValueError, match="2\\^31"):
        hcz3d_fused.run_fused_3d(f, f, p, 1)
    assert torch.cuda.memory_allocated() == allocated
    assert profiling.counter("kernel.steps.hcz3d_step") == before
    del f


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
    before2 = profiling.counter("kernel.steps.hcz_step")
    before3 = profiling.counter("kernel.steps.hcz3d_step")
    assert coolbm.main(["rayleighTaylor2D", "--f32", "--steps", "64",
                        "--outdir", str(tmp_path / "rt")]) == 0
    assert coolbm.main(["laplace3D", "--f32", "--steps", "20",
                        "--outdir", str(tmp_path / "l3")]) == 0
    assert profiling.counter("kernel.steps.hcz_step") > before2
    assert profiling.counter("kernel.steps.hcz3d_step") > before3
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
