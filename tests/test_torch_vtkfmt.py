"""The port's C VTK formatter (``io/native/vtkfmt.c``, loaded by
``io/vtk.py``) against the plain numpy rendering it replaced, on the CPU.

Every field block is held byte for byte to ``VtkWriter.reference_dumps``:
float32 and float64 fields of several shapes, the values where C's and
Python's ``%g`` part or round across a decade, int scalars to the int64
extremes, 2- and 3-component vectors, and a dump that the driver's writer
thread writes.  The library's build is checked for what it must never do:
fall back to numpy, load a partial file, or truncate a block.
"""
import os
import threading

import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch.io import vtk
from multiphase_lbm_tpu_torch.runners.common import Driver
from multiphase_lbm_tpu_torch.utils import profiling

torch.set_num_threads(1)

F32 = np.finfo(np.float32)
EDGE_VALUES = [
    0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
    F32.tiny, -F32.tiny, F32.max, -F32.max, F32.smallest_subnormal,
    -F32.smallest_subnormal, 3 * F32.smallest_subnormal, 1e-40,
    1e39, -1e39, 1e-50, -1e300,                 # beyond float32's range
    9.999995, 9.9999951, 99999.95, 999999.5, 0.00099999951, -9.999995,
    1234565.0, 123456.5, 1000005.0, 0.5, 2.5, 1.5e-7,
    1e-05, 1e-4, 0.0001234567, 1e-5 * (1 - 1e-7), 100000.0, 999999.0,
    1e6, 1e16, 1e-38, 0.1, 1 / 3, -2 / 3, 65504.0, 16777217.0,
]


def _writer(shape, **kw):
    nz, ny, nx = (1,) * (3 - len(shape)) + tuple(shape)
    return vtk.VtkWriter(nx, ny, nz, **kw)


def _assert_same(w):
    assert w.dumps() == w.reference_dumps()


def _mixed(rng, shape, dtype):
    """Values across float32's decades and signs, a few exact zeros."""
    mant = rng.uniform(-10, 10, shape)
    expo = rng.integers(-12, 12, shape).astype(np.float64)
    vals = mant * 10.0 ** expo
    vals[rng.random(shape) < 0.05] = 0.0
    return vals.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (100, 100), (2, 3, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_float_scalars_and_vectors_match_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    w = _writer(shape, spacing=0.01, iteration=400)
    w.scalar("Density", rng.uniform(0.0, 2.0, shape).astype(dtype))
    w.scalar("Pressure", _mixed(rng, shape, dtype))
    w.vector("Force", _mixed(rng, (len(shape),) + shape, dtype))
    _assert_same(w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_edge_values_match_reference(dtype):
    vals = np.array(EDGE_VALUES, dtype=np.float64)
    with np.errstate(over="ignore"):
        vals = vals.astype(dtype)
    n = vals.size
    w = vtk.VtkWriter(n, 1)
    w.scalar("edges", vals[None])
    w.scalar("reversed", vals[::-1][None])
    w.vector("edges2", np.stack([vals, vals[::-1]])[:, None])
    w.vector("edges3", np.stack([vals, -vals, vals[::-1]])[:, None])
    with np.errstate(over="ignore"):
        _assert_same(w)
        # glibc writes "-nan" for a NaN with its sign bit set; Python "nan"
        assert "-nan" not in w.dumps()


def test_random_float32_bit_patterns_match_reference():
    """Any float32, NaN payloads and subnormals included."""
    rng = np.random.default_rng(20)
    vals = rng.integers(0, 2**32, 60_000, dtype=np.uint64).astype(np.uint32)
    w = vtk.VtkWriter(300, 200).scalar("bits", vals.view(np.float32).reshape(200, 300))
    _assert_same(w)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.uint8, np.bool_])
def test_int_scalars_match_reference(dtype):
    rng = np.random.default_rng(3)
    info = np.iinfo(dtype) if dtype is not np.bool_ else None
    lo, hi = (info.min, info.max) if info else (0, 1)
    vals = rng.integers(lo, hi, (7, 9), dtype=np.int64, endpoint=True)
    vals[0, :3] = [lo, hi, 0]
    if lo < 0:
        vals[1, :3] = [-1, -10, -1234567]
    w = vtk.VtkWriter(9, 7).scalar("Flag", vals.astype(dtype), as_int=True)
    _assert_same(w)


def test_int_from_float_data_truncates_as_reference():
    w = vtk.VtkWriter(4, 1).scalar("Flag", np.array([[1.9, -1.9, 0.4, 3.0]]),
                                   as_int=True)
    _assert_same(w)
    assert "1 -1 0 3 \n" in w.dumps()


@pytest.mark.parametrize("shape", [(6, 8), (3, 4, 5)], ids=["2d", "3d"])
@pytest.mark.parametrize("ncomp", [2, 3])
def test_vectors_match_reference(shape, ncomp):
    rng = np.random.default_rng(ncomp)
    w = _writer(shape).vector("u", rng.standard_normal((ncomp,) + shape) * 1e-3)
    _assert_same(w)
    if ncomp == 2:
        assert all(line.endswith(" 0") for line in
                   w.dumps().split("VECTORS u float\n")[1].splitlines()[:-1])


def test_vector_of_four_components_is_refused():
    with pytest.raises(ValueError, match="2 or 3 components"):
        vtk.VtkWriter(2, 2).vector("u", np.zeros((4, 2, 2))).dumps()


def test_worst_case_tokens_fit_the_tight_buffer():
    """Every value at the longest token ("-1.17549e-38", "-9223372036854775808")
    fills the buffer TOKEN_BYTES sizes and no more."""
    shape = (5, 7)
    w = vtk.VtkWriter(7, 5)
    w.scalar("f", np.full(shape, -F32.tiny, np.float32))
    w.scalar("i", np.full(shape, np.iinfo(np.int64).min), as_int=True)
    w.vector("v", np.full((3,) + shape, -F32.tiny, np.float32))
    _assert_same(w)
    lines = w.dumps().splitlines()
    assert "-1.17549e-38 -1.17549e-38 -1.17549e-38" in lines


def test_values_counter_counts_each_block():
    profiling.reset()
    w = vtk.VtkWriter(10, 4, 3)
    w.scalar("a", np.ones((3, 4, 10))).scalar("b", np.ones((3, 4, 10)), as_int=True)
    w.vector("u2", np.ones((2, 3, 4, 10))).vector("u3", np.ones((3, 3, 4, 10)))
    w.dumps()
    assert profiling.counter("vtk.values.native") == 120 + 120 + 360 + 360


def test_driver_dump_file_equals_reference(tmp_path):
    """A dump written on the async driver's writer thread: Density,
    Pressure and a 2-component Force, as the n100 droplet dumps them."""
    rng = np.random.default_rng(100)
    ny, nx = 20, 30
    rho = torch.as_tensor(rng.uniform(0.03, 0.3, (ny, nx)))
    pres = torch.as_tensor(_mixed(rng, (ny, nx), np.float64))
    force = torch.as_tensor(_mixed(rng, (2, ny, nx), np.float64))
    profiling.reset()
    drv = Driver(tmp_path, nx * ny, vtk_freq=400)
    for it in (0, 400, 800):
        drv.write_vtk(it, nx, ny, scalars=[("Density", rho), ("Pressure", pres)],
                      vectors=[("Force", force)])
    drv.finish()
    want = vtk.VtkWriter(nx, ny, iteration=800).scalar("Density", rho.numpy())
    want.scalar("Pressure", pres.numpy()).vector("Force", force.numpy())
    assert (tmp_path / vtk.sol_filename(800)).read_bytes() == \
        want.reference_dumps().encode()
    # three dumps of Density, Pressure and Force (three values a point)
    assert profiling.counter("vtk.values.native") == 3 * 5 * nx * ny


def test_too_small_buffer_raises(monkeypatch):
    w = vtk.VtkWriter(4, 3).scalar("a", np.full((3, 4), -123.456))
    monkeypatch.setattr(vtk, "TOKEN_BYTES", dict(vtk.TOKEN_BYTES, float=4))
    with pytest.raises(RuntimeError, match="too small"):
        w.dumps()


@pytest.mark.parametrize("entry", ["float32", "float64", "int", "vector"])
def test_c_entry_returns_minus_one_within_its_buffer(entry):
    """An entry given too small a buffer writes nothing past it."""
    lib = vtk.load_formatter()
    cap = 30
    buf = np.full(cap + 16, 0xAB, np.uint8)
    out = buf.ctypes.data
    if entry == "int":
        vals = np.full(12, -7, np.int64)
        got = lib.vtk_format_int(vals.ctypes.data, 12, 4, out, cap)
    elif entry == "vector":
        vals = np.full(12, -7, np.float32)
        got = lib.vtk_format_vector(vals.ctypes.data, 0, 4, 3, out, cap)
    else:
        vals = np.full(12, -7, entry)
        got = lib.vtk_format_float(vals.ctypes.data, int(entry == "float64"),
                                   12, 4, out, cap)
    assert got == -1
    assert (buf[cap:] == 0xAB).all()


def _private_build(monkeypatch, tmp_path, src=None):
    monkeypatch.setattr(vtk, "LIB_PATH", tmp_path / "_build" / "libvtkfmt.so")
    monkeypatch.setattr(vtk, "_lib", None)
    if src is not None:
        monkeypatch.setattr(vtk, "_SRC", src)


def test_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    bad = tmp_path / "vtkfmt.c"
    bad.write_text("long vtk_format_f32( { syntax error\n")
    _private_build(monkeypatch, tmp_path, bad)
    with pytest.raises(RuntimeError, match="failed to build") as err:
        vtk.VtkWriter(1, 1).scalar("a", np.zeros((1, 1))).dumps()
    assert "error" in str(err.value)
    assert not vtk.LIB_PATH.exists()


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _private_build(monkeypatch, tmp_path)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="cannot be built"):
        vtk.load_formatter()


def test_library_rebuilds_only_when_the_source_is_newer(monkeypatch, tmp_path):
    src = tmp_path / "vtkfmt.c"
    src.write_bytes(vtk._SRC.read_bytes())
    _private_build(monkeypatch, tmp_path, src)
    lib = vtk._build_formatter()
    built = lib.stat().st_mtime_ns
    os.utime(src, ns=(built - 10**9, built - 10**9))
    assert vtk._build_formatter().stat().st_mtime_ns == built
    os.utime(src, ns=(built + 10**9, built + 10**9))
    assert vtk._build_formatter().stat().st_mtime_ns != built


def test_concurrent_builds_leave_one_whole_library(monkeypatch, tmp_path):
    """Builds racing in one directory (as test workers run them) each rename a
    whole file into place and leave no temporary behind."""
    _private_build(monkeypatch, tmp_path)
    errors = []

    def build():
        try:
            vtk._build_formatter()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert [p.name for p in vtk.LIB_PATH.parent.iterdir()] == ["libvtkfmt.so"]
    w = vtk.VtkWriter(3, 2).scalar("a", np.arange(6.0).reshape(2, 3) / 7)
    _assert_same(w)
