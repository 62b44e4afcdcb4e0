"""The real CUDA source of the Shan–Chen kernel (``csrc/sc_step.cu``),
compiled with ``g++`` and run on the CPU, against the plain PyTorch path.

The stub ``cuda_runtime.h`` and the launch rewrite are those of
``tests/test_torch_hcz_emulated.py`` (a ``std::thread`` per CUDA thread, a
``std::barrier`` per block, ``__shared__`` as ``static``), plus
``sqrt`` from ``<cmath>`` and ``cudaGetErrorString``.  The C entry ``sc_step_*`` is called through
ctypes on CPU tensors, as ``ops/sc_fused._launch`` calls it on the card,
with its output buffers filled with NaN first, so that a slot no thread
writes shows up.

Cases (float64, atol 1e-12 against :func:`..models.shan_chen.run`, which
``tests/test_torch_shan_chen.py`` holds to JAX), each with BGK and MRT at
ω = 1.25 (ω = 1 hides the MRT term), over 1 and 3 steps: the periodic
droplet (the kernel reads no mask); the droplet on a wall with the Yuan
wall ψ on the centre node's branch and on ρ_w's own; an obstacle across
tile edges; the constant-G layered channel with a per-node force
(gx_u, gy_u ≠ 0); lattices that are not multiples of the 32 × 8 tile or
are narrower than its ring (channel 3 × 5, a constant-G 1 × 6 column,
periodic 7 × 2); one float32 case at rtol 2e-5, atol 2e-6.  The halo
entry's route on slabs thinner than a tile must equal, bit for bit, the
same rows of the whole lattice's run; the entry refuses 9·ny·nx >= 2^31.
Skips only where ``g++`` is absent.
"""
import ctypes
import dataclasses
import re
import shutil
import subprocess

import pytest
import torch

from multiphase_lbm_tpu_torch.models import shan_chen as sc
from multiphase_lbm_tpu_torch.ops import _build, _halo, sc_fused
from test_torch_hcz_emulated import STUB, _emulated_source

# see tests/test_torch_hcz.py: six xdist workers' thread pools spin
# against each other without this
torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL = 1e-12
_SC_CU = (_build.SRC_DIR / "sc_step.cu").read_text()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("sc_emu")
    (d / "cuda_runtime.h").write_text(
        STUB + "#include <cmath>\nusing std::sqrt;\n"
               "inline const char* cudaGetErrorString(cudaError_t) "
               "{ return \"emulated\"; }\n")
    (d / "sc_step.cpp").write_text(_emulated_source(_SC_CU))
    so = d / "libsc_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    "-I", str(d), "-o", str(so), str(d / "sc_step.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in ("sc_step_f32", "sc_step_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _build.ENTRY_POINTS[name]
        fn.restype = ctypes.c_int
    return lib


def _run(lib, f, fluid, p, n_steps, periodic=False):
    """The C entry on CPU tensors: ``n_steps`` steps of ``f``."""
    run = lib.sc_step_f64 if f.dtype == torch.float64 else lib.sc_step_f32
    a, b = torch.full_like(f, float("nan")), torch.full_like(f, float("nan"))
    mask = fluid.to(torch.float32).contiguous()
    consts = sc_fused.kernel_constants(p)
    _, ny, nx = f.shape
    f_in = f.clone()
    err = run(f.data_ptr(), a.data_ptr(), b.data_ptr(),
              None if periodic else mask.data_ptr(), ny, nx, int(periodic),
              n_steps, ctypes.addressof(consts), None)
    assert err == 0
    assert torch.equal(f, f_in)                   # the input is only read
    return a if n_steps % 2 else b


def _yuan(omega, collision, **kw):
    return sc.SCParams(omega=omega, collision=collision, rho_w=0.2,
                       gravity=1e-5, gx=-2e-5, **kw)


def _layered_params(omega, collision):
    p = sc.SCParams(omega=omega, collision=collision, TT0=0.95, rhol=0.21,
                    rhog=0.067, rho_w=0.067, psi_mode="const_g", G=-1.0,
                    gx_u=1e-6, gy_u=-3e-7, gx=1e-6)
    return dataclasses.replace(p, p_shift=sc.compute_p_shift(p))


def _droplet(nx, ny, p, periodic, obstacle=None):
    if periodic:
        f = sc.init_droplet(nx, ny, p, radius=nx / 4, dtype=torch.float64,
                            device=CPU)
        return p, f, sc.geometry_periodic(nx, ny, device=CPU), True
    f = sc.init_droplet(nx, ny, p, radius=nx / 4, center=(nx / 2, 3.0),
                        dtype=torch.float64, device=CPU)
    fluid = sc.geometry_channel_walls(nx, ny, device=CPU)
    if obstacle is not None:
        fluid[obstacle] = False
    return p, sc.apply_geometry(f, fluid), fluid, False


def _layers(nx, ny, p):
    f = sc.init_layers(nx, ny, p, device=CPU)
    fluid = sc.geometry_channel_walls(nx, ny, device=CPU)
    return p, sc.apply_geometry(f, fluid), fluid, False


CASES = {
    "periodic droplet 45x37": lambda om, col: _droplet(45, 37, _yuan(om, col),
                                                       True),
    "wall droplet 45x37 centre branch":
        lambda om, col: _droplet(45, 37, _yuan(om, col), False),
    "wall droplet 45x37 fixed branch":
        lambda om, col: _droplet(45, 37, _yuan(
            om, col, wall_psi_center_branch=False), False),
    # x 28–35 and y 5–11 cross the tile edges at x = 32 and y = 8
    "obstacle across tile edges 45x37":
        lambda om, col: _droplet(45, 37, _yuan(om, col), False,
                                 obstacle=(slice(5, 12), slice(28, 36))),
    "const_g layers 45x37": lambda om, col: _layers(45, 37,
                                                    _layered_params(om, col)),
    "channel 3x5": lambda om, col: _droplet(3, 5, _yuan(om, col), False),
    # one column: the ring's x index wraps twice over
    "const_g layers 1x6": lambda om, col: _layers(1, 6,
                                                  _layered_params(om, col)),
    "periodic 7x2": lambda om, col: _droplet(7, 2, _yuan(om, col), True),
}


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("collision", ["bgk", "mrt"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_matches_plain(lib, case, collision, n_steps):
    p, f, fluid, periodic = CASES[case](1.25, collision)
    out = _run(lib, f, fluid, p, n_steps, periodic)
    ref = sc.run(f, fluid, p, n_steps)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, rtol=0.0, atol=ATOL)


@pytest.mark.parametrize("case", ["obstacle across tile edges 45x37",
                                  "const_g layers 45x37"])
@pytest.mark.parametrize("nsub,interior", [(1, 1), (1, 2), (2, 1)])
def test_emulated_halo_entry_matches_plain_and_whole_lattice(lib, case, nsub,
                                                             interior):
    """The halo entry's route (the kernel ``nsub`` times on a slab with
    REACH·nsub halo rows, then the interior) on slabs of 5, 6 and 9 rows:
    within 1e-12 of ``step_halo_plain`` and bit-identical to the whole
    lattice's run."""
    p, f, fluid, _ = CASES[case](1.25, "mrt")
    H = sc_fused.REACH * nsub
    y0 = 7                                    # interior rows y0 .. y0+interior-1
    rows = torch.arange(y0 - H, y0 + interior + H) % f.shape[1]
    f_ext, fl_ext = f[:, rows].contiguous(), fluid[rows].contiguous()
    out = _halo.interior(_run(lib, f_ext, fl_ext, p, nsub), H, 1)
    ref = sc_fused.step_halo_plain(f_ext, fl_ext.to(torch.float32), p, nsub)
    whole = _run(lib, f, fluid, p, nsub)
    torch.testing.assert_close(out, ref, rtol=0.0, atol=ATOL)
    assert torch.equal(out, whole[:, y0:y0 + interior])


@pytest.mark.parametrize("case", ["obstacle across tile edges 45x37",
                                  "const_g layers 45x37"])
def test_emulated_float32_matches_plain(lib, case):
    """The float32 instantiation, 5 steps at the port's SC float32
    tolerance (rtol 2e-5, atol 2e-6)."""
    p, f, fluid, _ = CASES[case](1.25, "mrt")
    f32 = f.float()
    out = _run(lib, f32, fluid, p, 5)
    ref = sc.run(f32, fluid, p, 5)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-6)


def test_entry_refuses_lattices_past_32_bit_indices(lib):
    """9 · ny · nx >= 2^31 returns cudaErrorInvalidValue and touches
    nothing (every pointer here is null)."""
    consts = sc_fused.kernel_constants(sc.SCParams())
    for ny, nx in ((16384, 16384), (4096, 58255)):
        assert lib.sc_step_f32(*[None] * 4, ny, nx, 1, 1,
                               ctypes.addressof(consts), None) == 1


def test_wrapper_mirrors_the_kernel_source():
    """``TILE`` is the source's (TILE_Y, TILE_X), and ``_SCConst`` has the
    fields of ``struct SCConst`` in its order (``tests/test_torch_ops.py``
    holds the C entries' argument types to their signatures)."""
    m = re.search(r"constexpr int TILE_X = (\d+), TILE_Y = (\d+);", _SC_CU)
    assert (int(m.group(2)), int(m.group(1))) == sc_fused.TILE
    body = re.search(r"struct SCConst \{(.*?)\};", _SC_CU, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [re.sub(r"\[\d+\]", "", v.strip()).split()[-1]
             for decl in body.split(";") if decl.strip()
             for v in decl.split(",")]
    assert names == [name for name, _ in sc_fused._SCConst._fields_]
