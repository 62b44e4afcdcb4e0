"""The real CUDA source of the HCZ 2D kernel (``csrc/hcz_step.cu``),
compiled with ``g++`` and run on the CPU, against the plain PyTorch path.

A stub ``cuda_runtime.h`` (written into the test's temporary directory)
emulates what the kernel uses of CUDA: each thread of a block is a
``std::thread``, ``__syncthreads()`` is a ``std::barrier`` shared by the
block, ``__shared__`` makes a variable static (one block-wide buffer, since
the blocks of a launch run one after another, each ending at the barrier),
and the harness rewrites every ``kernel<<<grid, block, smem, stream>>>(…)``
into a call of ``emu_launch``.  For ``tests/test_torch_pulsatile_emulated.py``
the stub also gives ``atomicAdd``/``atomicOr`` (GCC atomics) and stream
capture: launches made while capturing are recorded, and a launched graph
runs them in order.  The C entry point is then called through
ctypes on CPU tensors, with its argument types taken from
``ops/_build.ENTRY_POINTS``, and its outputs filled with NaN first, so that
a slot no thread writes shows up.

Cases (float64, atol 1e-12 against :func:`..models.hcz.run`, which
``tests/test_torch_hcz.py`` holds to JAX): channels of 45 × 37 and 3 × 5
(nx × ny: not multiples of the kernel's tile), a layered 1 × 6 (a column
that the 2-cell halo wraps around twice), a periodic 7 × 2, an obstacle
across tile edges, a 256-wide RTI strip of 24 rows, 1 and 3 steps, ω = 1.25 and 1.96 (ω = 1
hides the (1 − ω) terms); the halo entry's route on slabs thinner than a
tile, whose interior must equal, bit for bit, the same rows of the whole
lattice's run.  Skips only where ``g++`` is absent.
"""
import ctypes
import dataclasses
import re
import shutil
import subprocess

import pytest
import torch

from multiphase_lbm_tpu_torch.models import hcz
from multiphase_lbm_tpu_torch.ops import _build, _grid, _halo, hcz_fused
from multiphase_lbm_tpu_torch.validation.rti_regression import rti_state

# see tests/test_torch_hcz.py: six xdist workers' thread pools spin
# against each other without this
torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL = 1e-12

STUB = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <chrono>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// Stream capture: launches made while capturing are recorded, and a
// launched graph runs them in order.
struct EmuGraph {
  std::vector<std::function<void()>> ops;
};
typedef EmuGraph* cudaGraph_t;
typedef EmuGraph* cudaGraphExec_t;
enum cudaStreamCaptureMode { cudaStreamCaptureModeThreadLocal = 1 };
#define cudaStreamNonBlocking 1u
inline EmuGraph* emu_capture = nullptr;
inline cudaError_t cudaStreamCreateWithFlags(cudaStream_t* s, unsigned) {
  *s = nullptr;
  return cudaSuccess;
}
inline cudaError_t cudaStreamDestroy(cudaStream_t) { return cudaSuccess; }
inline cudaError_t cudaStreamBeginCapture(cudaStream_t,
                                          cudaStreamCaptureMode) {
  emu_capture = new EmuGraph;
  return cudaSuccess;
}
inline cudaError_t cudaStreamEndCapture(cudaStream_t, cudaGraph_t* g) {
  *g = emu_capture;
  emu_capture = nullptr;
  return cudaSuccess;
}
inline cudaError_t cudaGraphInstantiate(cudaGraphExec_t* e, cudaGraph_t g,
                                        unsigned long long = 0) {
  *e = new EmuGraph(*g);
  return cudaSuccess;
}
inline cudaError_t cudaGraphLaunch(cudaGraphExec_t e, cudaStream_t) {
  for (auto& op : e->ops) op();
  return cudaSuccess;
}
inline cudaError_t cudaGraphExecDestroy(cudaGraphExec_t e) {
  delete e;
  return cudaSuccess;
}
inline cudaError_t cudaGraphDestroy(cudaGraph_t g) {
  delete g;
  return cudaSuccess;
}
template <typename T>
T __ldcg(const T* p) { return *p; }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicOr(int* p, int v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
// A warp shuffle: every thread of the block posts its value, then reads
// the one delta lanes down within its warp of 32 (its own past the warp's
// end).  Every thread of the block must call it, as every thread of a
// warp must call the real one with a full mask.
template <typename T>
T __shfl_down_sync(unsigned, T v, unsigned delta) {
  static T posted[1024];
  const unsigned t = threadIdx.x + blockDim.x * (threadIdx.y +
                                                 blockDim.y * threadIdx.z);
  posted[t] = v;
  __syncthreads();
  const T out = t % 32 + delta < 32 ? posted[t + delta] : v;
  __syncthreads();
  return out;
}

// One std::thread per thread of a block; each runs the kernel for every
// block in turn and waits at the barrier after each, so the next block
// finds the static (__shared__) buffers free.  A thread that leaves the
// kernel before a __syncthreads the others reach would hang the block:
// abort instead.
template <typename K, typename... A>
void emu_run(dim3 grid, dim3 block, K kernel, A... args) {
  blockDim = block;
  gridDim = grid;
  const unsigned nt = block.x * block.y * block.z;
  std::barrier<> bar(nt);
  emu_barrier = &bar;
  std::atomic<unsigned> done{0};
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t % block.x, t / block.x % block.y,
                       t / (block.x * block.y));
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; ++bx) {
            blockIdx = dim3(bx, by, bz);
            kernel(args...);
            bar.arrive_and_wait();
          }
      done.fetch_add(1);
    });
  const auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::seconds(120);
  while (done.load() < nt) {
    if (std::chrono::steady_clock::now() > deadline) {
      std::fprintf(stderr, "emu_launch: a block did not finish\n");
      std::abort();
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  for (auto& t : threads) t.join();
}

template <typename K, typename... A>
void emu_launch(dim3 grid, dim3 block, size_t, cudaStream_t, K kernel,
                A... args) {
  if (emu_capture)
    emu_capture->ops.push_back([=] { emu_run(grid, block, kernel, args...); });
  else
    emu_run(grid, block, kernel, args...);
}
"""

_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\(", re.S)


def _emulated_source(src: str) -> str:
    """``kernel<…><<<cfg>>>(args)`` → ``emu_launch(cfg, kernel<…>, args)``."""
    out, n = _LAUNCH.subn(r"emu_launch(\2, \1, ", src)
    assert n >= 1, "no kernel launch found in the source"
    return out


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("hcz_emu")
    (d / "cuda_runtime.h").write_text(STUB)
    src = (_build.SRC_DIR / "hcz_step.cu").read_text()
    (d / "hcz_step.cpp").write_text(_emulated_source(src))
    so = d / "libhcz_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    "-I", str(d), "-o", str(so), str(d / "hcz_step.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in ("hcz_step_f32", "hcz_step_f64", "hcz_record_f32",
                 "hcz_record_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _build.ENTRY_POINTS[name]
        fn.restype = ctypes.c_int
    return lib


def _run(lib, f, g, fluid, p, n_steps):
    """The C entry on CPU tensors: ``n_steps`` steps of ``(f, g)``."""
    run = lib.hcz_step_f64 if f.dtype == torch.float64 else lib.hcz_step_f32
    bufs = [torch.full_like(f, float("nan")) for _ in range(4)]
    mask = fluid.to(torch.float32).contiguous()
    consts = hcz_fused.kernel_constants(p)
    _, ny, nx = f.shape
    f_in, g_in = f.clone(), g.clone()
    err = run(f.data_ptr(), g.data_ptr(), *(b.data_ptr() for b in bufs),
              mask.data_ptr(), ny, nx, n_steps, ctypes.addressof(consts), None)
    assert err == 0
    assert torch.equal(f, f_in) and torch.equal(g, g_in)   # inputs only read
    return (bufs[0], bufs[1]) if n_steps % 2 else (bufs[2], bufs[3])


def _channel(nx, ny, omega, obstacle=None, init=hcz.init_rayleigh_taylor):
    p = hcz.HCZParams(omega=omega, gravity=-1e-5, kappa=0.01)
    fluid = hcz.geometry_channel(nx, ny, device=CPU)
    if obstacle is not None:
        fluid[obstacle] = False
    st = init(nx, ny, p, dtype=torch.float64, device=CPU)
    return p, hcz.apply_geometry(st, fluid), fluid


def _periodic(nx, ny, omega):
    p = hcz.HCZParams(omega=omega, gravity=-1e-5, kappa=0.01)
    fluid = torch.ones((ny, nx), dtype=torch.bool)
    return p, hcz.init_rayleigh_taylor(nx, ny, p, dtype=torch.float64,
                                       device=CPU), fluid


def _rti_strip(omega):
    """Rows 500–523 of the RTI channel 256 × 1026 (the interface), a
    24-row strip that wraps in y."""
    p, (f, g), fluid = rti_state(256, CPU, torch.float64)
    p = dataclasses.replace(p, omega=omega)
    rows = slice(500, 524)
    return (p, (f[:, rows].contiguous(), g[:, rows].contiguous()),
            fluid[rows].contiguous())


CASES = {
    "channel 45x37": lambda om: _channel(45, 37, om),
    "channel 3x5": lambda om: _channel(3, 5, om),
    # one column (layers: the RTI perturbation divides by nx − 1): the
    # halo's x index wraps twice over
    "layers 1x6": lambda om: _channel(1, 6, om, init=hcz.init_layers),
    "periodic 7x2": lambda om: _periodic(7, 2, om),
    # x 28–35 and y 5–11 cross the tile edges at x = 32 and y = 8
    "obstacle across tile edges 45x37":
        lambda om: _channel(45, 37, om,
                            obstacle=(slice(5, 12), slice(28, 36))),
    "rti strip 256x24": _rti_strip,
}


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("omega", [1.25, 1.96])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_matches_plain(lib, case, omega, n_steps):
    p, st, fluid = CASES[case](omega)
    out = _run(lib, *st, fluid, p, n_steps)
    ref = hcz.run(st, fluid, p, n_steps)
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0.0, atol=ATOL)


@pytest.mark.parametrize("nsub,interior", [(1, 1), (1, 2), (2, 1)])
def test_emulated_halo_entry_matches_plain_and_whole_lattice(lib, nsub,
                                                             interior):
    """The halo entry's route (the kernel ``nsub`` times on a slab with
    REACH·nsub halo rows, then the interior) on slabs of 7, 8 and 13 rows
    out of the 45 × 37 channel with an obstacle: within 1e-12 of
    ``step_halo_plain`` and bit-identical to the whole lattice's run."""
    p, (f, g), fluid = CASES["obstacle across tile edges 45x37"](1.25)
    H = hcz_fused.REACH * nsub
    y0 = 9                                    # interior rows y0 .. y0+interior-1
    rows = torch.arange(y0 - H, y0 + interior + H) % f.shape[1]
    f_ext, g_ext = f[:, rows].contiguous(), g[:, rows].contiguous()
    fl_ext = fluid[rows].contiguous()
    out = [_halo.interior(t, H, 1)
           for t in _run(lib, f_ext, g_ext, fl_ext, p, nsub)]
    ref = hcz_fused.step_halo_plain(f_ext, g_ext, fl_ext.to(torch.float32),
                                    p, nsub)
    whole = _run(lib, f, g, fluid, p, nsub)
    for a, b, w in zip(out, ref, whole):
        torch.testing.assert_close(a, b, rtol=0.0, atol=ATOL)
        assert torch.equal(a, w[:, y0:y0 + interior])


def test_emulated_float32_matches_plain(lib):
    """The float32 instantiation, 5 steps at the port's HCZ 2D float32
    tolerance (rtol 3e-5, atol 3e-6)."""
    p, st, fluid = CASES["obstacle across tile edges 45x37"](1.25)
    st32 = tuple(t.float() for t in st)
    out = _run(lib, *st32, fluid, p, 5)
    ref = hcz.run(st32, fluid, p, 5)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=3e-5, atol=3e-6)


def test_entry_refuses_lattices_past_32_bit_indices(lib):
    """9 · ny · nx >= 2^31 returns cudaErrorInvalidValue and touches
    nothing (every pointer here is null)."""
    consts = hcz_fused.kernel_constants(hcz.HCZParams())
    for ny, nx in ((16384, 16384), (4096, 58255)):
        assert lib.hcz_step_f32(*[None] * 7, ny, nx, 1,
                                ctypes.addressof(consts), None) == 1


# ─── the record kernel (hcz_record_*) ──────────────────────────────────────
def _record(lib, f, g, fluid, p):
    """The record entry on CPU tensors, its workspace and output filled
    with NaN first: ``[E, spike, bubble]``."""
    run = lib.hcz_record_f64 if f.dtype == torch.float64 else lib.hcz_record_f32
    _, ny, nx = f.shape
    tiles = _grid.launch_geometry(ny, nx, hcz_fused.TILE)
    ws = torch.full((2 * tiles[0] * tiles[1] + 1,), float("nan"),
                    dtype=torch.float64)
    out = torch.full((3,), float("nan"), dtype=torch.float64)
    mask = fluid.to(torch.float32).contiguous()
    consts = hcz_fused.kernel_constants(p)
    err = run(f.data_ptr(), g.data_ptr(), mask.data_ptr(), ws.data_ptr(),
              out.data_ptr(), ny, nx, ctypes.addressof(consts),
              0.5 * (p.phi_l + p.phi_g), None)
    assert err == 0
    return out


RECORD_CASES = dict(CASES)
# a whole RTI channel whose interface crosses both scan columns
RECORD_CASES["rti channel 40x66"] = lambda om: _channel(40, 66, om)


def _driven_layers(omega):
    """The layered channel 16 × 12 with both x drives (ρ·gx and Gx_const)."""
    p = hcz.HCZParams(omega=omega, kappa=0.001, gx=1e-4, Gx_const=1e-5)
    fluid = hcz.geometry_channel(16, 12, device=CPU)
    st = hcz.init_layers(16, 12, p, dtype=torch.float64, device=CPU)
    return p, hcz.apply_geometry(st, fluid), fluid


RECORD_CASES["layers 16x12 driven"] = _driven_layers


@pytest.mark.parametrize("n_steps", [0, 3])
@pytest.mark.parametrize("omega", [1.25, 1.96])
@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_emulated_record_matches_plain(lib, case, omega, n_steps):
    """The record kernel's energy within 1e-12 of
    :func:`..models.hcz.kinetic_energy` and its heights equal to
    :func:`..models.hcz.interface_heights`' (through ``record_2d``'s CPU
    path), at columns nx/2 and 0, in float64."""
    p, st, fluid = RECORD_CASES[case](omega)
    st = hcz.run(st, fluid, p, n_steps)
    got = _record(lib, *st, fluid, p)
    want = hcz_fused.record_2d(*st, fluid.to(torch.float32), p, heights=True)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[0], want[0], rtol=1e-12, atol=0.0)
    assert got[1:].tolist() == want[1:].tolist()


def test_emulated_record_finds_the_interface_and_repeats_its_bits(lib):
    """In the 40 × 66 RTI channel the heights are inside the lattice (not
    0, not the top row); float32 within 1e-5 of the plain float32 energy;
    the same state gives the same bits twice; a lattice past 32-bit
    indices is refused (cudaErrorInvalidValue)."""
    p, st, fluid = RECORD_CASES["rti channel 40x66"](1.25)
    st32 = tuple(t.float() for t in hcz.run(st, fluid, p, 3))
    got = _record(lib, *st32, fluid, p)
    want = hcz_fused.record_2d(*st32, fluid.to(torch.float32), p,
                               heights=True)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
    assert got[1:].tolist() == want[1:].tolist()
    assert all(0 < h < 64 for h in got[1:].tolist())
    assert got[1] != got[2]
    assert torch.equal(_record(lib, *st32, fluid, p), got)
    consts = hcz_fused.kernel_constants(p)
    out = torch.zeros(3, dtype=torch.float64)
    assert lib.hcz_record_f32(*[None] * 4, out.data_ptr(), 16384, 16384,
                              ctypes.addressof(consts), 0.1, None) == 1
