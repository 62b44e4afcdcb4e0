"""The real CUDA source of the HCZ D3Q19 kernel (``csrc/hcz3d_step.cu``),
compiled with ``g++`` and run on the CPU, against the plain PyTorch path.

The stub ``cuda_runtime.h`` and the launch rewrite are those of
``tests/test_torch_hcz_emulated.py`` (a ``std::thread`` per CUDA thread, a
``std::barrier`` per block, ``__shared__`` as ``static``).  The C entry
``hcz3d_step_*`` is called through ctypes on CPU tensors, as
``ops/hcz3d_fused._launch`` calls it on the card, with its output buffers
and its φ scratch filled with NaN first, so that a slot no thread writes
shows up.

Cases (float64, atol 1e-12 against :func:`..models.hcz.run` with
``three_d=True``, which ``tests/test_torch_hcz3d.py`` holds to JAX): a
droplet with seeded noise (numpy) on every population, so that no symmetry
hides a direction's fault, with gravity, in boxes (nx × ny × nz) of
37 × 11 × 9 and 3 × 5 × 4 (not multiples of the 32 × 8 tile), 7 × 5 × 2
and 6 × 9 × 3 (thinner than the 7-plane φ window: the ring wraps more than
once) and 33 × 9 × 20 (two chunks of z-planes); 1 and 3 steps at ω = 1.2
and 1.96; one float32 case at the port's 3D tolerance (rtol 5e-5, atol
5e-6).  The halo entry's route on z-slabs, some thinner than a chunk, must
equal, bit for bit, the same planes of the whole box's run in either type
(with the halo of ``hcz3d_fused.REACH``, 4 planes a step: 3 would miss
g's); the entry refuses 19·nz·ny·nx >= 2^31.  The record entry
(``hcz3d_record_*``: the φ pass and the record tile) on the same boxes,
from the droplet and after 2 plain steps at either ω, within rtol 1e-12 of
:func:`..models.hcz.kinetic_energy` with ``three_d=True`` in float64 and
rtol 5e-5 in float32, with its workspace and output filled with NaN first;
it repeats its bits and refuses what the step refuses.  Skips only where
``g++`` is absent.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch.models import hcz
from multiphase_lbm_tpu_torch.ops import _build, _grid, _halo, hcz3d_fused
from multiphase_lbm_tpu_torch.ops import hcz_fused
from test_torch_hcz_emulated import STUB, _emulated_source

# see tests/test_torch_hcz.py: six xdist workers' thread pools spin
# against each other without this
torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL = 1e-12
_HCZ3D_CU = (_build.SRC_DIR / "hcz3d_step.cu").read_text()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("hcz3d_emu")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "hcz3d_step.cpp").write_text(_emulated_source(_HCZ3D_CU))
    so = d / "libhcz3d_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    "-I", str(d), "-o", str(so), str(d / "hcz3d_step.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in ("hcz3d_step_f32", "hcz3d_step_f64", "hcz3d_record_f32",
                 "hcz3d_record_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _build.ENTRY_POINTS[name]
        fn.restype = ctypes.c_int
    return lib


def _run(lib, f, g, p, n_steps):
    """The C entry on CPU tensors: ``n_steps`` steps of ``(f, g)``."""
    run = lib.hcz3d_step_f64 if f.dtype == torch.float64 else lib.hcz3d_step_f32
    bufs = [torch.full_like(f, float("nan")) for _ in range(4)]
    phi = torch.full(f.shape[1:], float("nan"), dtype=f.dtype)
    consts = hcz_fused.kernel_constants(p)
    _, nz, ny, nx = f.shape
    f_in, g_in = f.clone(), g.clone()
    err = run(f.data_ptr(), g.data_ptr(), *(b.data_ptr() for b in bufs),
              phi.data_ptr(), nz, ny, nx, n_steps, ctypes.addressof(consts),
              None)
    assert err == 0
    assert torch.equal(f, f_in) and torch.equal(g, g_in)   # inputs only read
    return (bufs[0], bufs[1]) if n_steps % 2 else (bufs[2], bufs[3])


def _plain(f, g, p, n_steps):
    fluid = torch.ones(f.shape[1:], dtype=torch.bool)
    return hcz.run((f, g), fluid, p, n_steps, lattice=hcz.D3Q19, three_d=True)


def _droplet(nx, ny, nz, omega, dtype=torch.float64, seed=0):
    """A droplet of radius min(n)/3 with gravity, and noise of 1% of each
    population's weight drawn with numpy from ``seed``."""
    p = hcz.HCZParams(omega=omega, kappa=5e-3, gravity=-1e-5)
    f, g = hcz.init_droplet_3d(nx, ny, nz, p, radius=min(nx, ny, nz) / 3.0,
                               dtype=torch.float64, device=CPU)
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(np.asarray(hcz.D3Q19.w))[:, None, None, None]
    f = f * (1.0 + 1e-2 * torch.as_tensor(rng.uniform(-1, 1, f.shape)))
    g = g + 1e-2 * w * torch.as_tensor(rng.uniform(-1, 1, g.shape)) * \
        float(g.sum(0).mean())
    return p, f.to(dtype).contiguous(), g.to(dtype).contiguous()


BOXES = {
    "37x11x9": (37, 11, 9),
    "3x5x4": (3, 5, 4),
    "7x5x2 (nz below the phi window)": (7, 5, 2),
    "6x9x3 (nz below the phi window)": (6, 9, 3),
    "33x9x20 (two chunks)": (33, 9, 20),
}


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("omega", [1.2, 1.96])
@pytest.mark.parametrize("box", sorted(BOXES))
def test_emulated_kernel_matches_plain(lib, box, omega, n_steps):
    p, f, g = _droplet(*BOXES[box], omega)
    out = _run(lib, f, g, p, n_steps)
    ref = _plain(f, g, p, n_steps)
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0.0, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nsub,interior,z0", [(1, 1, 5), (1, 2, 15),
                                              (2, 1, 0), (2, 4, 17)])
def test_emulated_halo_entry_matches_plain_and_whole_box(lib, nsub, interior,
                                                         z0, dtype):
    """The halo entry's route (the kernel ``nsub`` times on a z-slab with
    REACH·nsub halo planes, then the interior) on slabs of 9 and 10 planes
    (thinner than a chunk) and of 17 and 20 (two chunks) out of the
    33 × 9 × 20 box, across its chunk edge at z = 16 or its periodic end:
    within 1e-12 of ``step_halo_plain_3d`` and bit-identical to the whole
    box's run, in float64 and in float32 (against the plain path at rtol
    5e-5, atol 5e-6)."""
    p, f, g = _droplet(33, 9, 20, 1.2, dtype=dtype)
    tol = (dict(rtol=0.0, atol=ATOL) if dtype == torch.float64
           else dict(rtol=5e-5, atol=5e-6))
    H = hcz3d_fused.REACH * nsub
    planes = torch.arange(z0 - H, z0 + interior + H) % f.shape[1]
    f_ext, g_ext = f[:, planes].contiguous(), g[:, planes].contiguous()
    out = [_halo.interior(t, H, 1) for t in _run(lib, f_ext, g_ext, p, nsub)]
    ref = hcz3d_fused.step_halo_plain_3d(f_ext, g_ext, p, nsub)
    whole = _run(lib, f, g, p, nsub)
    for a, b, w in zip(out, ref, whole):
        torch.testing.assert_close(a, b, **tol)
        assert torch.equal(a, w[:, planes[H:H + interior]])


def test_emulated_float32_matches_plain(lib):
    """The float32 instantiation, 5 steps at the port's HCZ 3D float32
    tolerance (rtol 5e-5, atol 5e-6)."""
    p, f, g = _droplet(37, 11, 9, 1.2, dtype=torch.float32)
    out = _run(lib, f, g, p, 5)
    ref = _plain(f, g, p, 5)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=5e-5, atol=5e-6)


def test_entry_refuses_boxes_past_32_bit_indices(lib):
    """19 · nz · ny · nx >= 2^31 returns cudaErrorInvalidValue and touches
    nothing (every pointer here is null)."""
    consts = hcz_fused.kernel_constants(hcz.HCZParams())
    for nz, ny, nx in ((512, 512, 512), (1024, 1024, 108), (1, 1, 113025456)):
        assert lib.hcz3d_step_f32(*[None] * 7, nz, ny, nx, 1,
                                  ctypes.addressof(consts), None) == 1


@pytest.mark.parametrize("nz,ny,nx,grid", [
    (128, 128, 128, (8, 16, 4)),
    (9, 11, 37, (1, 2, 2)),
    (2, 5, 7, (1, 1, 1)),
    (448, 448, 448, (28, 56, 14)),   # 1.7 G slots, inside 2^31
])
def test_launch_geometry_3d_covers_the_box(nz, ny, nx, grid):
    assert _grid.launch_geometry_3d(nz, ny, nx, hcz3d_fused.TILE,
                                    hcz3d_fused.ZC) == grid


@pytest.mark.parametrize("nz,ny,nx", [(512, 512, 512), (0, 4, 4), (4, 0, 4),
                                      (1, 524289, 1), (1048577, 1, 1)])
def test_launch_geometry_3d_refuses_what_the_kernel_cannot_index(nz, ny, nx):
    """19·nz·ny·nx >= 2^31, an empty box, and more than 65,535 tile rows
    or chunks raise."""
    with pytest.raises(ValueError):
        _grid.launch_geometry_3d(nz, ny, nx, hcz3d_fused.TILE, hcz3d_fused.ZC)


@pytest.mark.parametrize("name,ints", [
    ("hcz3d_step_f32", (7, ["nz", "ny", "nx", "n_steps"])),
    ("hcz3d_step_f64", (7, ["nz", "ny", "nx", "n_steps"])),
    ("hcz3d_record_f32", (5, ["nz", "ny", "nx"])),
    ("hcz3d_record_f64", (5, ["nz", "ny", "nx"])),
])
def test_wrapper_mirrors_the_kernel_source(name, ints):
    """``TILE`` and ``ZC`` are the source's, and each C entry takes the
    box's extents (and n_steps) where the wrapper passes them
    (``tests/test_torch_ops.py`` holds its argument types to the
    signature)."""
    m = re.search(r"constexpr int TILE_X = (\d+), TILE_Y = (\d+), ZC = (\d+);",
                  _HCZ3D_CU)
    assert (int(m.group(2)), int(m.group(1))) == hcz3d_fused.TILE
    assert int(m.group(3)) == hcz3d_fused.ZC
    params = re.search(rf"int {name}\(([^)]*)\)", _HCZ3D_CU).group(1)
    first, names = ints
    assert [a.split()[-1].lstrip("*") for a in params.split(",")][
        first:first + len(names)] == names


# ─── the record entry (hcz3d_record_*) ──────────────────────────────────────
def _record(lib, f, g, p):
    """The record entry on CPU tensors, its φ scratch, workspace and output
    filled with NaN first: ``[E]``."""
    run = (lib.hcz3d_record_f64 if f.dtype == torch.float64
           else lib.hcz3d_record_f32)
    _, nz, ny, nx = f.shape
    grid = _grid.launch_geometry_3d(nz, ny, nx, hcz3d_fused.TILE,
                                    hcz3d_fused.ZC)
    phi = torch.full(f.shape[1:], float("nan"), dtype=f.dtype)
    ws = torch.full((grid[0] * grid[1] * grid[2] + 1,), float("nan"),
                    dtype=torch.float64)
    out = torch.full((1,), float("nan"), dtype=torch.float64)
    consts = hcz_fused.kernel_constants(p)
    f_in, g_in = f.clone(), g.clone()
    err = run(f.data_ptr(), g.data_ptr(), phi.data_ptr(), ws.data_ptr(),
              out.data_ptr(), nz, ny, nx, ctypes.addressof(consts), None)
    assert err == 0
    assert torch.equal(f, f_in) and torch.equal(g, g_in)   # inputs only read
    return out


def _plain_energy(f, g, p):
    fluid = torch.ones(f.shape[1:], dtype=torch.bool)
    return float(hcz.kinetic_energy((f, g), fluid, p, hcz.D3Q19,
                                    three_d=True))


@pytest.mark.parametrize("n_steps", [0, 2])
@pytest.mark.parametrize("omega", [1.2, 1.96])
@pytest.mark.parametrize("box", sorted(BOXES))
def test_emulated_record_matches_plain(lib, box, omega, n_steps):
    """The record's energy within rtol 1e-12 of the plain float64 energy of
    the noisy droplet with gravity, as it starts and after 2 plain steps."""
    p, f, g = _droplet(*BOXES[box], omega)
    f, g = _plain(f, g, p, n_steps)
    got = _record(lib, f, g, p)
    want = _plain_energy(f, g, p)
    assert want > 0.0 and bool(torch.isfinite(got).all())
    assert got.item() == pytest.approx(want, rel=1e-12, abs=0.0)


def test_emulated_record_float32_repeats_its_bits_and_refuses(lib):
    """The float32 instantiation within rtol 5e-5 of the plain float32
    energy (the port's HCZ 3D float32 tolerance) on the two-chunk box; the
    same state gives the same bits twice; a box past 32-bit indices is
    refused (cudaErrorInvalidValue) and nothing is touched."""
    p, f, g = _droplet(33, 9, 20, 1.2, dtype=torch.float32)
    f, g = _plain(f, g, p, 2)
    got = _record(lib, f, g, p)
    assert got.item() == pytest.approx(_plain_energy(f, g, p), rel=5e-5,
                                       abs=0.0)
    assert torch.equal(_record(lib, f, g, p), got)
    consts = hcz_fused.kernel_constants(p)
    for nz, ny, nx in ((512, 512, 512), (1, 1, 113025456)):
        assert lib.hcz3d_record_f32(*[None] * 5, nz, ny, nx,
                                    ctypes.addressof(consts), None) == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_record_3d_on_the_cpu_is_the_plain_energy(dtype):
    """``record_3d`` on CPU tensors: a float64 ``[E]`` holding
    ``kinetic_energy``'s value, bit for bit."""
    p, f, g = _droplet(7, 5, 4, 1.2, dtype=dtype)
    got = hcz3d_fused.record_3d(f, g, p)
    fluid = torch.ones(f.shape[1:], dtype=torch.bool)
    want = hcz.kinetic_energy((f, g), fluid, p, hcz.D3Q19, three_d=True)
    assert got.dtype == torch.float64 and got.shape == (1,)
    assert got.item() == float(want)
