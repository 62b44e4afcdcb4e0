"""The real CUDA source of the pulsatile kernel (``csrc/pulsatile_step.cu``),
compiled with ``g++ -ffp-contract=off`` and run on the CPU, against the
plain PyTorch path.

The stub ``cuda_runtime.h`` and the launch rewrite are those of
``tests/test_torch_hcz_emulated.py`` (a ``std::thread`` per CUDA thread, a
``std::barrier`` per block, ``atomicAdd``/``atomicOr`` as GCC atomics).
The C entry ``pulsatile_run_*`` is called through ctypes on CPU tensors, as
``ops/pulsatile_fused.run_fused_full`` calls it on the card, with its
outputs and scratch filled with NaN (and −7 in the index buffers) first, so
that a slot no thread writes shows up.

Cases (float64, atol 1e-12 on every field, identical fluid maps and diag
counts, against :func:`..models.pulsatile.run_with_diag`): the reference
vessel 621 × 64 after 4 steps, advanced 1 and 3 steps; ``n_steps = 0``; a
191 × 21 vessel (neither side a multiple of the tile's 64 × 4 band), also
over 9 and 10 steps, which replay a captured graph of two steps; a narrow
vessel where top-wall links read cells that the bottom pass wrote; walls
that cross, where both passes write a few populations (the top pass's
stand); walls drawn at random and crossing, where top links read what the
bottom wall's jump nodes write; the
many-fresh-cells state (walls set back by twice their next displacement,
with fresh cells at x = 0 and nx − 1); one float32 step.  On an
order-dependent step the kernel fills densely by design, where the plain
path fills sequentially: there the reference is the plain path with the
dense fill (``_dense_fill`` reporting no dependence), and the kernel's
order-dependent count must equal the plain path's.  The geometry tail's
fresh-row window (``pulsatile_fresh_map_*``, the tail's own code) is held
to the plain per-cell test on random walls, walls past the channel centre,
on integer rows, far outside the lattice, infinite and NaN.  Skips only
where ``g++`` is absent.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch.models import pulsatile as pm
from multiphase_lbm_tpu_torch.ops import _build
from multiphase_lbm_tpu_torch.ops import pulsatile_fused as pf
from test_torch_hcz_emulated import STUB, _emulated_source

# see tests/test_torch_hcz.py: six xdist workers' thread pools spin
# against each other without this
torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL = 1e-12
NAN = float("nan")
P64 = pm.PulsatileParams(nx=621, ny=64)
FIELDS = ("g_coll", "g_stream", "P", "Ux", "Uy", "yr1", "yr2", "F")


@pytest.fixture(scope="module", params=["as built", "marching"])
def lib(request, tmp_path_factory):
    """The source as it is built, and ("marching") with BLOCKS_AIM = 1, so
    that each block of the tile launch marches down up to 16 bands (at
    these sizes the source as built gives a block one band)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("pulsatile_emu")
    (d / "cuda_runtime.h").write_text(STUB)
    src = (_build.SRC_DIR / "pulsatile_step.cu").read_text()
    if request.param == "marching":
        aim = re.search(r"constexpr int BLOCKS_AIM = [^;]*;", src).group(0)
        src = src.replace(aim, "constexpr int BLOCKS_AIM = 1;")
    (d / "pulsatile_step.cpp").write_text(_emulated_source(src))
    so = d / "libpulsatile_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", str(d), "-o", str(so),
                    str(d / "pulsatile_step.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in ("pulsatile_run_f32", "pulsatile_run_f64",
                 "pulsatile_fresh_map_f32", "pulsatile_fresh_map_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _build.ENTRY_POINTS[name]
        fn.restype = ctypes.c_int
    return lib


def _run(lib, st, t0, p, n_steps):
    """The C entry on CPU tensors, with run_fused_full's buffers: ``(state,
    [order-dependent steps, reseeded cells, overflowed steps])``."""
    dt = st.g_coll.dtype
    run = lib.pulsatile_run_f64 if dt == torch.float64 else lib.pulsatile_run_f32
    src = (st.g_coll, st.g_stream, torch.stack([st.P, st.Ux, st.Uy]),
           torch.stack([st.yr1, st.yr2]))
    bufs = [tuple(torch.full_like(t, NAN) for t in src) for _ in range(2)]
    nx, cap = p.nx, 4 * p.nx + 256
    bz_idx = torch.full((12 * nx,), -7, dtype=torch.int32)
    bz_val = torch.full((12 * nx,), NAN, dtype=dt)
    rs_idx = torch.full((cap,), -7, dtype=torch.int32)
    rs_val = torch.full((9 * cap,), NAN, dtype=dt)
    ctr = torch.zeros(8, dtype=torch.int32)
    consts = pf.kernel_constants(p)
    before = [t.clone() for t in src]
    err = run(*(t.data_ptr() for t in src),
              *(t.data_ptr() for b in bufs for t in b), bz_idx.data_ptr(),
              bz_val.data_ptr(), rs_idx.data_ptr(), rs_val.data_ptr(),
              ctr.data_ptr(), p.ny, nx, cap, n_steps, int(t0),
              ctypes.addressof(consts), None)
    assert err == 0
    assert all(torch.equal(a, b) for a, b in zip(src, before))  # only read
    if n_steps == 0:
        assert all(bool(t.isnan().all()) for b in bufs for t in b)
        gc, gs, mac, yr = src
    else:
        gc, gs, mac, yr = bufs[(n_steps - 1) % 2]
    F = pm.fobj_from_walls(yr[0], yr[1], p)
    return (pm.PulsatileState(gc, gs, yr[0], yr[1], mac[0], mac[1], mac[2],
                              F, pm.flags_from_fobj(F, p)),
            ctr[:3].tolist())


def _dense_reference(monkeypatch, st, t0, p, n_steps):
    """The plain path with the kernel's dense fill on order-dependent steps:
    ``(state, (order-dependent steps, reseeded cells))``."""
    dense = pm._dense_fill
    dep_steps = []

    def fill(g, Ffrac, fresh, pp):
        val, dep_map = dense(g, Ffrac, fresh, pp)
        dep_steps.append(bool(dep_map.any()))
        return val, torch.zeros_like(dep_map)

    with monkeypatch.context() as m:
        m.setattr(pm, "_dense_fill", fill)
        ref, (_, n_cells) = pm.run_with_diag(st, t0, p, n_steps)
    return ref, (sum(dep_steps), n_cells)


def _assert_equal_to(out, diag, ref, counts, tol=ATOL):
    assert diag == [*counts, 0]
    assert torch.equal(out.fluid, ref.fluid)
    for name in FIELDS:
        a, b = getattr(out, name), getattr(ref, name)
        assert bool(torch.isfinite(a).all()), name
        lim = tol[name] if isinstance(tol, dict) else tol
        err = float((a.double() - b.double()).abs().max())
        assert err <= lim, (name, err)


@pytest.fixture(scope="module")
def vessel64():
    """The reference vessel after 4 plain steps."""
    return pm.run(pm.initialize(P64, torch.float64, device=CPU), 0, P64, 4)


def _small_vessel():
    """191 × 21 (N = 21): 191 = 5·32 + 31 columns, 21 = 2·8 + 5 rows."""
    p = pm.PulsatileParams(nx=191, ny=21)
    return p, pm.run(pm.initialize(p, torch.float64, device=CPU), 0, p, 4)


def _narrow_vessel():
    """221 × 24 with walls 0.3 to 1.1 rows from the centre below and 0.33
    to 1.21 above: in a passage a row or two wide, top-wall links read
    populations that the bottom pass wrote."""
    p = pm.PulsatileParams(nx=221, ny=24)
    st = pm.run(pm.initialize(p, torch.float64, device=CPU), 0, p, 4)
    X = torch.arange(p.nx, dtype=torch.float64)
    w = 0.3 + 0.8 * (1 + torch.sin(X / 5.0)) / 2
    yr1, yr2 = p.yc - w, p.yc + 1.1 * w
    F = pm.fobj_from_walls(yr1, yr2, p)
    fl = pm.flags_from_fobj(F, p)
    return p, st._replace(yr1=yr1, yr2=yr2, F=F, fluid=fl, P=st.P * fl,
                          Ux=st.Ux * fl, Uy=st.Uy * fl)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_vessel_621x64_matches_plain(lib, vessel64, n_steps):
    out, diag = _run(lib, vessel64, 4, P64, n_steps)
    ref, counts = pm.run_with_diag(vessel64, 4, P64, n_steps)
    assert counts[0] == 0 and counts[1] > 0
    _assert_equal_to(out, diag, ref, counts)


def test_zero_steps_write_nothing(lib, vessel64):
    out, diag = _run(lib, vessel64, 4, P64, 0)
    assert diag == [0, 0, 0]
    _assert_equal_to(out, diag, vessel64, (0, 0), tol=0.0)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_lattice_off_the_tile_matches_plain(lib, n_steps):
    p, st = _small_vessel()
    assert p.nx % pf.TILE[1] and p.ny % pf.TILE[0]
    out, diag = _run(lib, st, 4, p, n_steps)
    ref, counts = pm.run_with_diag(st, 4, p, n_steps)
    assert counts[0] == 0 and counts[1] > 0
    _assert_equal_to(out, diag, ref, counts)


@pytest.mark.parametrize("n_steps", [9, 10])
def test_graph_replay_matches_plain(lib, monkeypatch, n_steps):
    """Calls of GRAPH_STEPS (8) steps or more run step 0, then replay a
    captured graph of two steps (the step index from the device counter),
    then at most one more step: against the plain path and against as many
    calls of one step."""
    src = (_build.SRC_DIR / "pulsatile_step.cu").read_text()
    assert "constexpr int GRAPH_STEPS = 8;" in src
    p, st = _small_vessel()
    t0 = p.t_start + 40        # the inlet pressure changes every step
    out, diag = _run(lib, st, t0, p, n_steps)
    ref, counts = _dense_reference(monkeypatch, st, t0, p, n_steps)
    assert counts[1] > 0
    _assert_equal_to(out, diag, ref, counts)
    one = st
    for i in range(n_steps):
        one, _ = _run(lib, one, t0 + i, p, 1)
    assert all(torch.equal(a, b) for a, b in zip(out, one))


@pytest.mark.parametrize("n_steps", [1, 3])
def test_narrow_vessel_matches_plain(lib, monkeypatch, n_steps):
    """The top pass reads the bottom pass's writes (checked on the plain
    path first).  The walls' first move is order-dependent, so the
    reference fills densely; its count equals the plain path's."""
    p, st = _narrow_vessel()
    gout = pm.collide(st, p)
    d_bot, d_top = pm.border_deltas(st.F, st.yr1, st.yr2, p)
    g_bot = pm._bouzidi_one(gout, st.F, d_bot, p, pm.BOTTOM_SLOTS)
    seen = pm._bouzidi_one(g_bot, st.F, d_top, p, pm.TOP_SLOTS)
    unseen = pm._bouzidi_one(gout, st.F, d_top, p, pm.TOP_SLOTS)
    assert bool(((seen != unseen) & (seen != g_bot)).any())
    out, diag = _run(lib, st, 4, p, n_steps)
    ref, counts = _dense_reference(monkeypatch, st, 4, p, n_steps)
    _, (n_dep, _) = pm.run_with_diag(st, 4, p, 1)
    assert n_dep == 1 and counts[0] >= 1 and counts[1] > 0
    _assert_equal_to(out, diag, ref, counts)


def test_crossing_walls_top_pass_wins(lib, monkeypatch):
    """Walls that cross the channel centre and each other: a few (cell,
    population) pairs are written by both passes, and the top pass's value
    stands (the tile overlays the bottom slots first)."""
    p = pm.PulsatileParams(nx=221, ny=24)
    st = pm.run(pm.initialize(p, torch.float64, device=CPU), 0, p, 4)
    X = torch.arange(p.nx, dtype=torch.float64)
    yr1 = p.yc - 1.0 + 3.0 * torch.sin(X / 6.0)
    yr2 = p.yc + 1.0 - torch.sin(X / 4.0)
    F = pm.fobj_from_walls(yr1, yr2, p)
    fl = pm.flags_from_fobj(F, p)
    st = st._replace(yr1=yr1, yr2=yr2, F=F, fluid=fl, P=st.P * fl,
                     Ux=st.Ux * fl, Uy=st.Uy * fl)
    gout = pm.collide(st, p)
    d_bot, d_top = pm.border_deltas(st.F, st.yr1, st.yr2, p)
    g_bot = pm._bouzidi_one(gout, st.F, d_bot, p, pm.BOTTOM_SLOTS)
    marked = torch.full_like(gout, 7.0)
    by_top = pm._bouzidi_one(marked, st.F, d_top, p, pm.TOP_SLOTS) != 7.0
    assert bool(((g_bot != gout) & by_top).any())
    out, diag = _run(lib, st, 4, p, 1)
    ref, counts = _dense_reference(monkeypatch, st, 4, p, 1)
    _assert_equal_to(out, diag, ref, counts)


def test_random_crossing_walls_match_plain(lib, monkeypatch):
    """Walls drawn at random for every column, crossing each other in places:
    top links also read cells that the jump nodes of the bottom wall write
    (the jump node of column X + 1 writes in column X)."""
    p = pm.PulsatileParams(nx=221, ny=24)
    st = pm.run(pm.initialize(p, torch.float64, device=CPU), 0, p, 4)
    rng = np.random.default_rng(2)
    yr1 = p.yc - torch.from_numpy(rng.uniform(-2.0, 1.0, p.nx))
    yr2 = p.yc + torch.from_numpy(rng.uniform(-2.0, 1.0, p.nx))
    F = pm.fobj_from_walls(yr1, yr2, p)
    fl = pm.flags_from_fobj(F, p)
    st = st._replace(yr1=yr1, yr2=yr2, F=F, fluid=fl, P=st.P * fl,
                     Ux=st.Ux * fl, Uy=st.Uy * fl)
    out, diag = _run(lib, st, 4, p, 1)
    ref, counts = _dense_reference(monkeypatch, st, 4, p, 1)
    _assert_equal_to(out, diag, ref, counts)


def test_many_fresh_cells_match_plain(lib):
    """The 27-step N = 64 vessel (tests/test_torch_pulsatile.py's
    many-fresh-cells state) with its walls set back by twice their next
    displacement: the step reseeds about a hundred cells, at x = 0 and
    nx − 1 too."""
    st = pm.run(pm.initialize(P64, torch.float64, device=CPU), 0, P64, 27)
    y1m, y2m = pm.move_walls(st.P, st.yr1, st.yr2, P64)
    yr1, yr2 = st.yr1 - 2.0 * (y1m - st.yr1), st.yr2 - 2.0 * (y2m - st.yr2)
    F = pm.fobj_from_walls(yr1, yr2, P64)
    st = st._replace(yr1=yr1, yr2=yr2, F=F, fluid=pm.flags_from_fobj(F, P64))
    out, diag = _run(lib, st, 27, P64, 1)
    ref, counts = pm.run_with_diag(st, 27, P64, 1)
    fresh = pf.fresh_map_plain(torch.stack([st.yr1, st.yr2]),
                               torch.stack([ref.yr1, ref.yr2]), P64)
    assert counts[0] == 0 and counts[1] > 80
    assert bool(fresh[:, 0].any()) and bool(fresh[:, -1].any())
    _assert_equal_to(out, diag, ref, counts)


@pytest.mark.parametrize("case", ["621x64 from step 0", "191x21 from step 1"])
def test_order_dependent_step_fills_densely_and_counts(lib, monkeypatch,
                                                       case):
    p = P64 if case.startswith("621") else pm.PulsatileParams(nx=191, ny=21)
    t0 = int(case[-1])
    st = pm.run(pm.initialize(p, torch.float64, device=CPU), 0, p, t0)
    out, diag = _run(lib, st, t0, p, 1)
    _, plain_counts = pm.run_with_diag(st, t0, p, 1)
    ref, counts = _dense_reference(monkeypatch, st, t0, p, 1)
    assert plain_counts == counts and counts[0] == 1
    _assert_equal_to(out, diag, ref, counts)


def test_float32_step_matches_plain(lib):
    """One float32 step at the GPU test's float32 tolerances (the
    emulation measured 0 on every field)."""
    st = pm.run(pm.initialize(P64, torch.float32, device=CPU), 0, P64, 4)
    out, diag = _run(lib, st, 4, P64, 1)
    ref, counts = pm.run_with_diag(st, 4, P64, 1)
    assert out.g_coll.dtype == torch.float32
    _assert_equal_to(out, diag, ref, counts, tol={
        "g_coll": 5e-7, "g_stream": 5e-7, "P": 5e-7, "Ux": 5e-7,
        "Uy": 5e-7, "F": 1e-4, "yr1": 5e-5, "yr2": 5e-5})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", [0, 1])
def test_fresh_window_matches_per_cell_test(lib, dtype, seed):
    p = pm.PulsatileParams(nx=221, ny=24)
    yr, yr_new = pf.random_walls(p, dtype, seed)
    want = pf.fresh_map_plain(yr, yr_new, p)
    got = torch.zeros((p.ny, p.nx), dtype=torch.uint8)
    fn = (lib.pulsatile_fresh_map_f32 if dtype == torch.float32
          else lib.pulsatile_fresh_map_f64)
    consts = pf.kernel_constants(p)
    assert fn(yr.data_ptr(), yr_new.data_ptr(), got.data_ptr(), p.ny, p.nx,
              ctypes.addressof(consts), None) == 0
    assert int(want.sum()) > 100
    assert torch.equal(got.bool(), want)


def test_entry_refuses_bad_shapes(lib):
    """ny < 4, nx < 2 and 9 · ny · nx >= 2^31 return cudaErrorInvalidValue
    and touch nothing (every pointer here is null)."""
    consts = pf.kernel_constants(P64)
    for ny, nx in ((3, 64), (64, 1), (16384, 16384)):
        assert lib.pulsatile_run_f32(*[None] * 17, ny, nx, 16, 1, 0,
                                     ctypes.addressof(consts), None) == 1
        assert lib.pulsatile_fresh_map_f64(None, None, None, ny, nx,
                                           ctypes.addressof(consts),
                                           None) == 1


def test_tile_follows_the_source():
    src = (_build.SRC_DIR / "pulsatile_step.cu").read_text()
    m = re.search(r"constexpr int TILE_X = (\d+), TILE_Y = (\d+);", src)
    assert (int(m.group(2)), int(m.group(1))) == pf.TILE
