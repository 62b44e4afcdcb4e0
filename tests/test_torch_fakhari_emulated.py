"""The real CUDA source of the Fakhari kernel (``csrc/fakhari_step.cu``),
compiled with ``g++`` and run on the CPU, against the plain PyTorch path.

The stub ``cuda_runtime.h`` and the launch rewrite are those of
``tests/test_torch_hcz_emulated.py`` (a ``std::thread`` per CUDA thread, a
``std::barrier`` per block, ``__shared__`` as ``static``), plus ``sqrt``
from ``<cmath>``.  The C entry ``fakhari_step_*`` is called through ctypes
on CPU tensors with the arguments ``ops/fakhari_fused.step_calls`` forms
for the card (the modes, the ping-pong and the velocity pass that ends a
call), with every buffer filled with NaN first, so that a slot no thread
writes shows up.

Cases (float64, atol 1e-12 against :func:`..models.fakhari.run`, which
``tests/test_torch_fakhari.py`` holds to JAX), over 1 and 3 steps: the
bubble at τ = 0.8 and 0.55 on 46 × 38, a random state on 50 × 70 and on
lattices narrower than the tile's ring (7 × 2, 1 × 6), none a multiple of
the 32 × 8 tile; one float32 case at rtol 5e-5, atol 5e-6.  k calls of
one step give the state of one call of k steps, bit for bit; the halo
entry's route on slabs thinner than a tile must equal, bit for bit, the
same rows of the whole lattice's run; the entry refuses 9·ny·nx >= 2^31
and an unknown mode.  Skips only where ``g++`` is absent.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch.core.lattice import D2Q9
from multiphase_lbm_tpu_torch.models import fakhari as fk
from multiphase_lbm_tpu_torch.ops import _build, _halo, fakhari_fused
from test_torch_hcz_emulated import STUB, _emulated_source

# see tests/test_torch_hcz.py: six xdist workers' thread pools spin
# against each other without this
torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL = 1e-12
_CU = (_build.SRC_DIR / "fakhari_step.cu").read_text()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("fakhari_emu")
    (d / "cuda_runtime.h").write_text(STUB + "#include <cmath>\n"
                                             "using std::sqrt;\n")
    (d / "fakhari_step.cpp").write_text(_emulated_source(_CU))
    so = d / "libfakhari_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    "-I", str(d), "-o", str(so), str(d / "fakhari_step.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in ("fakhari_step_f32", "fakhari_step_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _build.ENTRY_POINTS[name]
        fn.restype = ctypes.c_int
    return lib


def _run(lib, state, p, n_steps):
    """One call of ``n_steps`` steps as ``fakhari_fused._launch`` makes it
    on the card, on CPU tensors; the input is only read."""
    fn = (lib.fakhari_step_f64 if state[0].dtype == torch.float64
          else lib.fakhari_step_f32)
    bufs = tuple(tuple(torch.full_like(t, float("nan")) for t in state)
                 for _ in range(2))
    before = tuple(t.clone() for t in state)
    consts = fakhari_fused.kernel_constants(p)
    for args in fakhari_fused.step_calls(state, bufs, n_steps, consts):
        assert fn(*args, None) == 0
    assert all(torch.equal(a, b) for a, b in zip(state, before))
    return fakhari_fused.result(bufs, n_steps)


def _random(ny, nx, dtype=torch.float64):
    """A state away from the bubble's symmetry (that of the gpu test)."""
    rng = np.random.default_rng(8)
    w = np.asarray(D2Q9.w)[:, None, None]
    C = rng.uniform(0.05, 0.95, (ny, nx))
    h = w * C[None] * (1.0 + 0.05 * rng.standard_normal((9, ny, nx)))
    g = 0.01 * rng.standard_normal((9, ny, nx))
    u = 0.01 * rng.standard_normal((2, ny, nx))
    return (fk.FakhariParams(tau=0.7, M=0.05),
            tuple(torch.as_tensor(a, dtype=dtype) for a in (h, g, u)))


def _bubble(nx, ny, tau):
    p = fk.FakhariParams(tau=tau)
    return p, fk.init_bubble(nx, ny, p, dtype=torch.float64, device=CPU)


CASES = {
    # even sides: an odd side puts the bubble's centre on a node, where
    # ∇φ = 0 and n is rounding noise (the plain path's noise differs)
    "bubble 46x38 tau=0.8": lambda: _bubble(46, 38, 0.8),
    "bubble 46x38 tau=0.55": lambda: _bubble(46, 38, 0.55),
    "random 50x70": lambda: _random(70, 50),
    "random 7x2": lambda: _random(2, 7),
    # one column: the ring's x index wraps twice over
    "random 1x6": lambda: _random(6, 1),
}


def _assert_close(out, ref, **tol):
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_matches_plain(lib, case, n_steps):
    p, st = CASES[case]()
    _assert_close(_run(lib, st, p, n_steps), fk.run(st, p, n_steps),
                  rtol=0.0, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emulated_calls_of_one_step_equal_one_call(lib, dtype):
    """Four calls of one step give the state of one call of four steps,
    bit for bit: the deferred velocity update is neither lost nor done
    twice at a call's boundary."""
    p, st = _random(37, 45, dtype)
    one = st
    for _ in range(4):
        one = _run(lib, one, p, 1)
    for a, b in zip(one, _run(lib, st, p, 4)):
        assert torch.equal(a, b)


def test_emulated_float32_matches_plain(lib):
    """The float32 instantiation, 5 steps at the port's Fakhari float32
    tolerance (rtol 5e-5, atol 5e-6)."""
    p, st = _bubble(46, 38, 0.8)
    st = tuple(t.float() for t in st)
    _assert_close(_run(lib, st, p, 5), fk.run(st, p, 5), rtol=5e-5,
                  atol=5e-6)


@pytest.mark.parametrize("nsub,interior", [(1, 1), (1, 3), (2, 2)])
def test_emulated_halo_entry_matches_plain_and_whole_lattice(lib, nsub,
                                                             interior):
    """The halo entry's route (``nsub`` steps and the velocity pass on a
    slab with REACH·nsub halo rows, then the interior) on slabs of 11 to 24
    rows: within 1e-12 of ``step_halo_plain`` and bit-identical to the
    whole lattice's run."""
    p, st = _random(70, 50)
    H = fakhari_fused.REACH * nsub
    y0 = 7                                    # interior rows y0 .. y0+interior-1
    rows = torch.arange(y0 - H, y0 + interior + H) % st[0].shape[1]
    ext = tuple(t[:, rows].contiguous() for t in st)
    out = tuple(_halo.interior(t, H, 1) for t in _run(lib, ext, p, nsub))
    ref = fakhari_fused.step_halo_plain(*ext, p, nsub)
    whole = _run(lib, st, p, nsub)
    _assert_close(out, ref, rtol=0.0, atol=ATOL)
    for a, b in zip(out, whole):
        assert torch.equal(a, b[:, y0:y0 + interior])


def test_entry_refuses_lattices_past_32_bit_indices_and_unknown_modes(lib):
    """9 · ny · nx >= 2^31, or a mode other than FIRST, STEP and VELOCITY,
    returns cudaErrorInvalidValue and touches nothing (every pointer here
    is null)."""
    consts = fakhari_fused.kernel_constants(fk.FakhariParams())
    for ny, nx, mode in ((16384, 16384, 1), (4096, 58255, 0), (8, 8, 3),
                         (8, 8, -1)):
        assert lib.fakhari_step_f32(*[None] * 6, ny, nx, mode,
                                    ctypes.addressof(consts), None) == 1


def test_wrapper_mirrors_the_kernel_source():
    """``TILE`` is the source's (TILE_Y, TILE_X) and the modes are the
    source's (``tests/test_torch_ops.py`` holds the C entries' argument
    types to their signatures)."""
    m = re.search(r"constexpr int TILE_X = (\d+), TILE_Y = (\d+);", _CU)
    assert (int(m.group(2)), int(m.group(1))) == fakhari_fused.TILE
    m = re.search(r"constexpr int FIRST = (\d+), STEP = (\d+), "
                  r"VELOCITY = (\d+);", _CU)
    assert tuple(map(int, m.groups())) == (fakhari_fused.FIRST,
                                           fakhari_fused.STEP,
                                           fakhari_fused.VELOCITY)
