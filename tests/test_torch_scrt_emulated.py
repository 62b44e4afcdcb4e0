"""The real CUDA source of the SC Rayleigh–Taylor record
(``csrc/scrt_step.cu``: ``psi_kernel`` and ``scrt_record_kernel`` behind
the ``scrt_record_*`` entries), compiled with ``g++`` and run on the CPU,
against the plain record.

The stub ``cuda_runtime.h`` of ``tests/test_torch_hcz_emulated.py``
emulates what the kernels use of CUDA (threads of a block as
``std::thread``, ``__syncthreads`` as a barrier, warp shuffles, the block
counter's ``atomicAdd`` and ``cudaMemsetAsync``); ``<cmath>``'s ``exp``
overloads give ψ in the state's type.  The C entry is called through
ctypes on CPU tensors, with its argument types from
``ops/_build.ENTRY_POINTS``, its output and scratch filled with NaN first.

Cases: channels of 45 × 37 and 3 × 5 (nx × ny: no multiple of a block's
256 cells), 64 × 98 (25 blocks) and 256 × 258 (258 blocks, so each thread
of the last block's pass adds up two partials), the interface at rest and
after plain steps at ω = 1 and 1.25, and random states; E and M in float64 to rtol 1e-12 against
:func:`..models.shan_chen_rt.kinetic_energy` and ``(density(f) *
fluid).sum()``, the rows exactly :func:`..models.shan_chen_rt.
interface_height`'s; columns with no light row (0), a light row only at
y = 1 or at y = ny − 2, a cell whose ρ is exactly the cut (it counts: the
rule is ≤) and one just above it (it does not); float32 at rtol 1e-5; two
calls on one state equal bit for bit; and :func:`..ops.scrt_fused.record`
on the CPU.  Skips only where ``g++`` is absent.
"""
import ctypes
import math
import re
import shutil
import subprocess

import pytest
import torch

from multiphase_lbm_tpu_torch.models import shan_chen_rt as rt
from multiphase_lbm_tpu_torch.ops import _build, scrt_fused
from test_torch_hcz_emulated import STUB, _emulated_source

# see tests/test_torch_hcz.py: six xdist workers' thread pools spin
# against each other without this
torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = dict(rtol=1e-12, atol=0.0)
F32 = dict(rtol=1e-5, atol=0.0)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("scrt_emu")
    (d / "cuda_runtime.h").write_text(STUB + "#include <cmath>\n"
                                             "using std::exp;\n")
    # the step's launch breaks its line before <<<, which the stub's
    # rewrite does not expect
    src = re.sub(r">\s+<<<", "><<<",
                 (_build.SRC_DIR / "scrt_step.cu").read_text())
    (d / "scrt_step.cpp").write_text(_emulated_source(src))
    so = d / "libscrt_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    "-I", str(d), "-o", str(so), str(d / "scrt_step.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in ("scrt_record_f32", "scrt_record_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _build.ENTRY_POINTS[name]
        fn.restype = ctypes.c_int
    return lib


def _record(lib, f, p):
    """The C entry on the CPU tensor ``f``: its four doubles."""
    run = lib.scrt_record_f64 if f.dtype == torch.float64 else lib.scrt_record_f32
    _, ny, nx = f.shape
    psi = torch.full((ny, nx), float("nan"), dtype=f.dtype)
    ws = torch.full((3 * scrt_fused.RECORD_BLOCKS + 1,), float("nan"),
                    dtype=torch.float64)
    out = torch.full((4,), float("nan"), dtype=torch.float64)
    f_in = f.clone()
    consts = scrt_fused.kernel_constants(p)
    err = run(f.data_ptr(), psi.data_ptr(), ws.data_ptr(), out.data_ptr(),
              ny, nx, ctypes.addressof(consts), 0.5 * (p.rhol + p.rhog), None)
    assert err == 0
    assert torch.equal(f, f_in)                   # the state is only read
    return out


def _plain(f, fluid, p):
    """(E, M, spike, bubble) of the plain functions the driver called."""
    rho = rt.density(f)
    return (float(rt.kinetic_energy(f, fluid, p)), float((rho * fluid).sum()),
            *rt.interface_height(rho.numpy(), fluid.numpy(), p))


def _check(got, want, tol):
    e, m, spike, bubble = got.tolist()
    assert math.isclose(e, want[0], rel_tol=tol["rtol"]), (e, want[0])
    assert math.isclose(m, want[1], rel_tol=tol["rtol"]), (m, want[1])
    assert (spike, bubble) == tuple(want[2:])


def _interface(nx, ny, omega=1.0, steps=0, dtype=torch.float64):
    p = rt.SCRTParams(omega=omega)
    fluid = rt.geometry_channel(nx, ny, device=CPU)
    f = rt.init_interface(nx, ny, p, dtype=dtype, device=CPU) * fluid[None]
    return p, rt.run(f, fluid, p, steps), fluid


def _random(nx, ny, seed, dtype=torch.float64):
    """Populations w_k ρ (1 + ξ), ρ uniform in 0.3–1.3 and ξ in ±0.2, so u
    reaches ~0.1 and ρ crosses the cut in every column; walls zero."""
    p = rt.SCRTParams(omega=1.25)
    g = torch.Generator().manual_seed(seed)
    fluid = rt.geometry_channel(nx, ny, device=CPU)
    rho = 0.3 + torch.rand((ny, nx), generator=g, dtype=torch.float64)
    xi = 0.4 * torch.rand((9, ny, nx), generator=g, dtype=torch.float64) - 0.2
    w = torch.tensor([1 / 9, 1 / 9, 1 / 36, 1 / 36, 4 / 9, 1 / 9, 1 / 9,
                      1 / 36, 1 / 36], dtype=torch.float64)[:, None, None]
    f = (w * rho * (1 + xi) * fluid).to(dtype)
    return p, f, fluid


CASES = {
    "interface 45x37 at rest": lambda: _interface(45, 37),
    "interface 45x37 after 6 steps": lambda: _interface(45, 37, steps=6),
    "interface 45x37 omega 1.25 after 6 steps":
        lambda: _interface(45, 37, omega=1.25, steps=6),
    "interface 3x5 after 2 steps": lambda: _interface(3, 5, steps=2),
    "interface 64x98 after 3 steps": lambda: _interface(64, 98, steps=3),
    # 258 blocks: the last block's threads take two partials each
    "interface 256x258 after 1 step": lambda: _interface(256, 258, steps=1),
    "random 45x37": lambda: _random(45, 37, 5),
    "random 3x5": lambda: _random(3, 5, 6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_record_matches_plain(lib, case):
    p, f, fluid = CASES[case]()
    _check(_record(lib, f, p), _plain(f, fluid, p), F64)


W = torch.tensor([1 / 9, 1 / 9, 1 / 36, 1 / 36, 4 / 9, 1 / 9, 1 / 9, 1 / 36,
                  1 / 36], dtype=torch.float64)


def _set_column(f, x, rho_by_row):
    """Column ``x`` of ``f`` at rest with the densities ``rho_by_row`` (one
    a fluid row, bottom up)."""
    rho = torch.as_tensor(rho_by_row, dtype=torch.float64)
    f[:, 1:-1, x] = (W[:, None] * rho[None]).to(f.dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("spike,bubble", [("none", "bottom"),
                                          ("top", "none"),
                                          ("bottom", "top")])
def test_emulated_rows_at_the_edges_of_the_column(lib, dtype, spike, bubble):
    """A column with no light row gives 0; a column light only at y = 1
    gives 1, and one light only at y = ny − 2 gives ny − 2."""
    p, f, fluid = _interface(45, 37, steps=2, dtype=dtype)
    ny = f.shape[1]
    rows = {"none": [p.rhol] * (ny - 2),
            "bottom": [p.rhog] + [p.rhol] * (ny - 3),
            "top": [p.rhol] * (ny - 3) + [p.rhog]}
    _set_column(f, 45 // 2, rows[spike])
    _set_column(f, 0, rows[bubble])
    want = _plain(f, fluid, p)
    row = {"none": 0.0, "bottom": 1.0, "top": ny - 2.0}
    assert want[2:] == (row[spike], row[bubble])
    _check(_record(lib, f, p), want, F64 if dtype == torch.float64 else F32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_emulated_row_at_the_cut_counts(lib, dtype):
    """A cell whose ρ is exactly the cut is light (the rule is ≤); a cell
    one ulp above it is not.  Their mass is all at rest, in f_4, so every
    order of the sum over k gives ρ exactly; the rows above them are
    heavy."""
    p, f, fluid = _interface(45, 37, steps=2, dtype=dtype)
    cut = torch.tensor(0.5 * (p.rhol + p.rhog), dtype=dtype)
    above = torch.nextafter(cut, torch.tensor(2.0, dtype=dtype))

    def at_rest(y, x, rho):
        f[:, y, x] = 0.0
        f[4, y, x] = rho

    for x, y in ((45 // 2, 30), (0, 33)):
        f[:, y + 1:-1, x] = (W[:, None] * p.rhol).to(dtype)
    at_rest(30, 45 // 2, cut)
    at_rest(33, 0, above)
    at_rest(32, 0, cut)
    want = _plain(f, fluid, p)
    assert want[2:] == (30.0, 32.0)
    _check(_record(lib, f, p), want, F64 if dtype == torch.float64 else F32)


@pytest.mark.parametrize("case", ["interface 45x37 omega 1.25 after 6 steps",
                                  "random 45x37"])
def test_emulated_float32_matches_plain(lib, case):
    p, f, fluid = CASES[case]()
    f = f.to(torch.float32)
    _check(_record(lib, f, p), _plain(f, fluid, p), F32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_emulated_record_repeats_bit_for_bit(lib, dtype):
    p, f, _ = _random(64, 98, 7, dtype)
    a, b = _record(lib, f, p), _record(lib, f, p)
    assert torch.equal(a, b)


def test_emulated_entry_refuses_a_channel_without_fluid_rows(lib):
    p = rt.SCRTParams()
    f = torch.zeros((9, 2, 8), dtype=torch.float64)
    psi = torch.zeros((2, 8), dtype=torch.float64)
    ws = torch.zeros(3 * scrt_fused.RECORD_BLOCKS + 1, dtype=torch.float64)
    out = torch.full((4,), float("nan"), dtype=torch.float64)
    err = lib.scrt_record_f64(f.data_ptr(), psi.data_ptr(), ws.data_ptr(),
                              out.data_ptr(), 2, 8,
                              ctypes.addressof(scrt_fused.kernel_constants(p)),
                              0.8, None)
    assert err != 0 and bool(out.isnan().all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_record_wrapper_on_the_cpu_is_the_plain_record(lib, dtype):
    """``scrt_fused.record`` on a CPU tensor: the plain values, which the
    emulated kernel matches."""
    p, f, fluid = _interface(45, 37, omega=1.25, steps=4, dtype=dtype)
    got = scrt_fused.record(f, fluid, p)
    assert got.dtype == torch.float64 and got.shape == (4,)
    assert got.tolist() == list(_plain(f, fluid, p))
    _check(_record(lib, f, p), got.tolist(),
           F64 if dtype == torch.float64 else F32)
