"""The lattice decomposition of the PyTorch port against the JAX package, on
the CPU: ``parallel/sharding.py``, the halo-in entries of the kernel
wrappers (``ops/*_fused.step_fused_halo``) and
``validation/multichip_check.py``.

Inputs are the JAX package's initial states with seeded numpy noise,
handed to both packages as numpy arrays.  Tolerances:

* the generic halo step against JAX's ``make_halo_step`` on the conftest's
  8-device CPU mesh, float64 atol 1e-13 (as tests/test_sharding.py);
* each halo-in entry against JAX's own halo-in entry in interpret mode on
  the same extended slab, at JAX's halo width and a small tile, float32
  rtol 2e-5, atol 2e-6 (as tests/test_pallas_sc.py);
* each decomposed path on 4 CPU shards (2 × 2 for the 2D paths), at the
  JAX checks' sizes and ``nsub``, against ``nsub · k`` steps of JAX's
  global XLA step, float64 atol 1e-12 (summation order differs).

JAX's own decomposed paths are not called here: their interpret-mode
compiles under shard_map overflow the XLA CPU compiler's stack in long
processes (multiphase_lbm_tpu/validation/multichip_check.py:3-8).  The
kernels on the card are held to these plain paths by
tests/test_torch_sharding_gpu.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.models import fakhari as jfk
from multiphase_lbm_tpu.models import hcz as jhcz
from multiphase_lbm_tpu.models import shan_chen as jsc
from multiphase_lbm_tpu.models import shan_chen_rt as jrt
from multiphase_lbm_tpu.ops import (pallas_fakhari, pallas_hcz, pallas_hcz3d,
                                    pallas_sc, pallas_scrt)
from multiphase_lbm_tpu.parallel import sharding as jsh
from multiphase_lbm_tpu_torch.models import fakhari as tfk
from multiphase_lbm_tpu_torch.models import hcz as thcz
from multiphase_lbm_tpu_torch.models import shan_chen as tsc
from multiphase_lbm_tpu_torch.models import shan_chen_rt as trt
from multiphase_lbm_tpu_torch.ops import (fakhari_fused, hcz3d_fused,
                                          hcz_fused, sc_fused, scrt_fused)
from multiphase_lbm_tpu_torch.parallel import sharding as sh
from multiphase_lbm_tpu_torch.utils.convert import (fakhari_params_from_jax,
                                                    hcz_params_from_jax,
                                                    params_from_jax,
                                                    scrt_params_from_jax)
from multiphase_lbm_tpu_torch.validation import multichip_check

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = dict(rtol=0.0, atol=1e-12)
F32 = dict(rtol=2e-5, atol=2e-6)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _noisy(arrays, seed, scale=1e-3):
    """float64 numpy copies of ``arrays``, each scaled by 1 + ``scale``·N(0, 1)
    noise cell by cell (zeros, such as solid cells, stay zero)."""
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(a, np.float64)
                 * (1.0 + scale * rng.standard_normal(np.shape(a)))
                 for a in arrays)


def _mesh(n, shape=None, names=("x",)):
    return sh.make_mesh(n, shape=shape, axis_names=names, devices=[CPU] * n)


def _slab(a, lo, hi, axis):
    """Cells ``lo .. hi − 1`` of ``a`` along ``axis``, wrapping."""
    return np.take(a, np.arange(lo, hi), axis=axis, mode="wrap")


# ─── the generic path ─────────────────────────────────────────────────────
@pytest.mark.parametrize("n,shape,names", [(4, None, ("x",)),
                                           (8, (2, 4), ("y", "x"))])
def test_halo_step_matches_jax(eight_devices, n, shape, names):
    """The generic halo step around the plain SC step (MRT at ω = 1.25, a
    walled channel), 3 steps on a 4-shard x ring and on a 2 × 4 (y, x)
    mesh, against JAX's make_halo_step on the virtual CPU mesh."""
    jp = jsc.SCParams(collision="mrt", omega=1.25)
    tp = params_from_jax(dataclasses.asdict(jp))
    fluid = jsc.geometry_channel_walls(64, 32)
    (f,) = _noisy([jsc.apply_geometry(
        jsc.init_droplet(64, 32, jp, radius=6.0, dtype=jnp.float64), fluid)], 1)

    jmesh = jsh.make_mesh(n, shape=shape, axis_names=names)
    jstep = jsh.make_halo_step(lambda a, b: jsc.step(a, b, jp), jmesh, width=2,
                               state_leading=(1, 0), n_state=1)
    jout = jsh.shard_lattice(jnp.asarray(f), jmesh, leading=1)
    jfl = jsh.shard_lattice(fluid, jmesh, leading=0)

    tmesh = _mesh(n, shape, names)
    tstep = sh.make_halo_step(lambda a, b: tsc.step(a, b, tp), tmesh, width=2,
                              state_leading=(1, 0), n_state=1)
    tout = sh.shard_lattice(_t(f), tmesh, leading=1)
    tfl = sh.shard_lattice(torch.as_tensor(np.array(fluid)), tmesh, leading=0)
    for _ in range(3):
        jout = jstep(jout, jfl)
        tout = tstep(tout, tfl)
    assert tout.shape == (9, 32, 64)
    np.testing.assert_allclose(tout.gather().numpy(), np.asarray(jout),
                               rtol=0.0, atol=1e-13)


# ─── the halo-in entries against JAX's, in interpret mode ──────────────────
def _halo_sc():
    jp = jsc.SCParams(collision="mrt", omega=1.25, rho_w=0.2)
    fluid = jsc.geometry_channel_walls(64, 128)
    (f,) = _noisy([jsc.apply_geometry(
        jsc.init_droplet(64, 128, jp, radius=12.0, center=(32.0, 6.0),
                         dtype=jnp.float64), fluid)], 2)
    # shard 0 of 4: its halo wraps to the top wall rows
    f_ext, m_ext = _slab(f, -8, 40, 1), _slab(np.asarray(fluid, np.float32),
                                             -8, 40, 0)
    ref = pallas_sc.step_fused_halo(jnp.asarray(f_ext, jnp.float32),
                                    jnp.asarray(m_ext), jp, tile=8,
                                    interpret=True, nsub=2, halo=8)
    out = sc_fused.step_fused_halo(_t(f_ext, torch.float32), _t(m_ext, torch.float32),
                                   params_from_jax(dataclasses.asdict(jp)),
                                   nsub=2, halo=8)
    return [(out, ref)]


def _halo_hcz():
    jp = jhcz.HCZParams(omega=1.25, gravity=-1e-5)
    fluid = jhcz.geometry_channel(64, 128)
    f, g = _noisy(jhcz.apply_geometry(
        jhcz.init_rayleigh_taylor(64, 128, jp, dtype=jnp.float64), fluid), 3)
    ext = [_slab(a, -8, 40, 1) for a in (f, g)]
    m_ext = _slab(np.asarray(fluid, np.float32), -8, 40, 0)
    ref = pallas_hcz.step_fused_halo(
        *(jnp.asarray(a, jnp.float32) for a in ext), jnp.asarray(m_ext), jp,
        tile=8, interpret=True, nsub=2, halo=8)
    out = hcz_fused.step_fused_halo(
        *(_t(a, torch.float32) for a in ext), _t(m_ext, torch.float32),
        hcz_params_from_jax(dataclasses.asdict(jp)), nsub=2, halo=8)
    return list(zip(out, ref))


def _halo_fakhari():
    jp = jfk.FakhariParams()
    h, g, u = jfk.init_bubble(64, 128, jp, dtype=jnp.float64)
    h, g = _noisy((h, g), 4)
    u = np.asarray(u) + 1e-5 * np.random.default_rng(5).standard_normal(u.shape)
    # shard 1 of 4, rows 32..63, holds the bubble's lower half
    ext = [_slab(a, 16, 80, 1) for a in (h, g, u)]
    ref = pallas_fakhari.step_fused_halo(
        *(jnp.asarray(a, jnp.float32) for a in ext), jp, tile=16,
        interpret=True, nsub=2, halo=16)
    out = fakhari_fused.step_fused_halo(
        *(_t(a, torch.float32) for a in ext),
        fakhari_params_from_jax(dataclasses.asdict(jp)), nsub=2, halo=16)
    return list(zip(out, ref))


def _halo_scrt():
    jp = jrt.SCRTParams(omega=1.25)
    nx, ny = 64, 130
    fluid = jrt.geometry_channel(nx, ny)
    (f,) = _noisy([jrt.init_interface(nx, ny, jp, dtype=jnp.float64)
                   * fluid[None]], 6)
    f_ext = _slab(f, -8, 24, 2)              # shard 0 of 4, 16 columns
    # JAX's slab is transposed and lane-padded: (9, nx_ext, ny_pad)
    ft = np.pad(np.transpose(f_ext, (0, 2, 1)), ((0, 0), (0, 0), (0, 256 - ny)))
    ref = pallas_scrt.step_fused_halo(jnp.asarray(ft, jnp.float32), jp, ny,
                                      tile=8, interpret=True, nsub=2, halo=8)
    ref = np.transpose(np.asarray(ref)[:, :, :ny], (0, 2, 1))
    out = scrt_fused.step_fused_halo(_t(f_ext, torch.float32),
                                     scrt_params_from_jax(dataclasses.asdict(jp)),
                                     nsub=2, halo=8)
    return [(out, ref)]


def _halo_hcz3d():
    jp = jhcz.HCZParams(omega=1.2, gravity=0.0, kappa=0.01)
    f, g = _noisy(jhcz.init_droplet_3d(16, 16, 32, jp, radius=5.0,
                                       dtype=jnp.float64), 7)
    # z-planes 0..23 of 32: the port's entry crops its REACH·nsub = 8
    # planes a side (planes 8..15), the Pallas entry its 6 (planes 6..17)
    ext = [_slab(a, 0, 24, 1) for a in (f, g)]
    ref = pallas_hcz3d.step_fused_halo_3d(
        *(jnp.asarray(a, jnp.float32) for a in ext), jp, tile=4,
        interpret=True, nsub=2)
    out = hcz3d_fused.step_fused_halo_3d(
        *(_t(a, torch.float32) for a in ext),
        hcz_params_from_jax(dataclasses.asdict(jp)), nsub=2)
    return [(o, np.asarray(r)[:, 2:-2]) for o, r in zip(out, ref)]


@pytest.mark.parametrize("family,run", [
    ("sc", _halo_sc), ("hcz", _halo_hcz), ("fakhari", _halo_fakhari),
    ("scrt", _halo_scrt), ("hcz3d", _halo_hcz3d)])
def test_halo_entry_matches_pallas_interpret(family, run):
    """Two sub-steps of the port's halo-in entry (the plain path, on the
    CPU) against JAX's in interpret mode on one extended slab, float32."""
    for out, ref in run():
        assert out.shape == np.shape(ref)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


# ─── the decomposed paths against JAX's global step ────────────────────────
def _sc_case(two_d):
    jp = jsc.SCParams(collision="mrt", omega=1.25)
    fluid = jsc.geometry_channel_walls(64, 32)
    (f,) = _noisy([jsc.apply_geometry(
        jsc.init_droplet(64, 32, jp, radius=6.0, dtype=jnp.float64), fluid)], 8)
    ref = jsc.run(jnp.asarray(f), fluid, jp, 4)
    mesh = _mesh(4, (2, 2), ("y", "x")) if two_d else _mesh(4, names=("y",))
    make = sh.make_fused_sc_step_2d if two_d else sh.make_fused_sc_step
    step = make(mesh, params_from_jax(dataclasses.asdict(jp)), nsub=2)
    m = sh.shard_lattice(_t(np.asarray(fluid), torch.float32), mesh, leading=0)
    out = sh.shard_lattice(_t(f), mesh)
    for _ in range(2):
        out = step(out, m)
    return [(out, ref)]


def _hcz_case(two_d):
    jp = jhcz.HCZParams(omega=1.25, gravity=-1e-5)
    nx, ny, nsub = (64, 64, 2) if two_d else (64, 128, 5)
    fluid = jhcz.geometry_channel(nx, ny)
    st = _noisy(jhcz.apply_geometry(
        jhcz.init_rayleigh_taylor(nx, ny, jp, dtype=jnp.float64), fluid), 9)
    ref = jhcz.run(tuple(jnp.asarray(a) for a in st), fluid, jp, 2 * nsub)
    mesh = _mesh(4, (2, 2), ("y", "x")) if two_d else _mesh(4, names=("y",))
    make = sh.make_fused_hcz_step_2d if two_d else sh.make_fused_hcz_step
    step = make(mesh, hcz_params_from_jax(dataclasses.asdict(jp)), nsub=nsub)
    m = sh.shard_lattice(_t(np.asarray(fluid), torch.float32), mesh, leading=0)
    out = tuple(sh.shard_lattice(_t(a), mesh) for a in st)
    for _ in range(2):
        out = step(*out, m)
    return list(zip(out, ref))


def _hcz3d_case():
    jp = jhcz.HCZParams(omega=1.2, gravity=0.0, kappa=0.01)
    st = _noisy(jhcz.init_droplet_3d(16, 16, 32, jp, radius=5.0,
                                     dtype=jnp.float64), 10)
    ref = jhcz.run(tuple(jnp.asarray(a) for a in st),
                   jhcz.geometry_periodic_3d(16, 16, 32), jp, 4,
                   lattice=jhcz.D3Q19, three_d=True)
    mesh = _mesh(4, names=("z",))
    step = sh.make_fused_hcz3d_step(
        mesh, hcz_params_from_jax(dataclasses.asdict(jp)), nsub=2)
    out = tuple(sh.shard_lattice(_t(a), mesh) for a in st)
    for _ in range(2):
        out = step(*out)
    return list(zip(out, ref))


def _fakhari_case():
    jp = jfk.FakhariParams()
    h, g, u = jfk.init_bubble(64, 128, jp, dtype=jnp.float64)
    st = _noisy((h, g), 11) + (np.asarray(u),)
    ref = jfk.run(tuple(jnp.asarray(a) for a in st), jp, 4)
    mesh = _mesh(4, names=("y",))
    step = sh.make_fused_fakhari_step(
        mesh, fakhari_params_from_jax(dataclasses.asdict(jp)), nsub=2)
    out = tuple(sh.shard_lattice(_t(a), mesh) for a in st)
    for _ in range(2):
        out = step(*out)
    return list(zip(out, ref))


def _scrt_case():
    jp = jrt.SCRTParams(omega=1.25)
    nx, ny = 32, 130
    fluid = jrt.geometry_channel(nx, ny)
    (f,) = _noisy([jrt.init_interface(nx, ny, jp, dtype=jnp.float64)
                   * fluid[None]], 12)
    ref = jrt.run(jnp.asarray(f), fluid, jp, 4)
    mesh = _mesh(4, names=("x",))
    step = sh.make_fused_scrt_step(
        mesh, scrt_params_from_jax(dataclasses.asdict(jp)), nsub=2)
    out = sh.shard_lattice(_t(f), mesh)
    for _ in range(2):
        out = step(out)
    return [(out, ref)]


@pytest.mark.parametrize("name,run", [
    ("sc", lambda: _sc_case(False)), ("sc2d", lambda: _sc_case(True)),
    ("hcz_wide", lambda: _hcz_case(False)), ("hcz2d", lambda: _hcz_case(True)),
    ("hcz3d", _hcz3d_case), ("fakhari", _fakhari_case), ("scrt", _scrt_case)])
def test_decomposed_path_matches_jax_global_step(name, run):
    """Two calls of each make_fused_*_step (4 shards; 2 × 2 for the 2D
    paths; HCZ 1D at nsub = 5, the others at nsub = 2) against JAX's global
    XLA run of as many steps, float64."""
    before = (sc_fused.HALO_LAUNCHES, hcz_fused.HALO_LAUNCHES,
              hcz3d_fused.HALO_LAUNCHES, fakhari_fused.HALO_LAUNCHES,
              scrt_fused.HALO_LAUNCHES)
    for out, ref in run():
        assert out.shape == np.shape(ref)
        np.testing.assert_allclose(out.gather().numpy(), np.asarray(ref), **F64)
    # on the CPU the halo entries run the plain path and launch nothing
    assert before == (sc_fused.HALO_LAUNCHES, hcz_fused.HALO_LAUNCHES,
                      hcz3d_fused.HALO_LAUNCHES, fakhari_fused.HALO_LAUNCHES,
                      scrt_fused.HALO_LAUNCHES)


# ─── the port on its own ───────────────────────────────────────────────────
@pytest.mark.parametrize("name", sorted(multichip_check.CASES))
def test_multichip_check_cli_on_cpu(name, capsys):
    """Every subcommand at its default size, on 4 CPU shards: the decomposed
    path equals the single-lattice run."""
    assert multichip_check.main([name, "--device", "cpu"]) == 0
    assert "OK" in capsys.readouterr().out


@pytest.mark.parametrize("family", list(multichip_check.HALO_ENTRIES))
def test_halo_entry_case_on_cpu(family):
    """The slab cases of the card's halo-kernel checks: on the CPU both
    sides run the plain path, agree exactly and launch nothing."""
    res = multichip_check.check_halo_entry(family, torch.float64, 2, "cpu")
    assert res["ok"] and res["max_abs_err"] == 0.0
    assert res["launched"] == res["launched_main"] == 0


@pytest.mark.parametrize("name", sorted(multichip_check.CASES))
def test_compute_half_against_plain_on_cpu(name):
    """The full-width kernel check's comparison, at the default size on
    the CPU: the compute half against the plain version of the local step
    (with the x crop on the 2D paths) on the same extended blocks."""
    case, _ = multichip_check.make_case(name, "cpu", dtype=torch.float64)
    state, static = multichip_check._shards(case)
    ext = case.step.exchange(*state, *static)
    res = multichip_check.against_plain(case, ext, case.step.compute(*ext))
    assert res["plain_ok"] and res["plain_err"] == 0.0


def test_halo_bound_cells():
    """Sub-step j of nsub keeps the own cells and reach·(nsub − j) more on
    each side of every cut axis."""
    case, _ = multichip_check.make_case("hcz3d", "cpu")
    # 4 z shards of 8 planes of 16 × 16, nsub 2, reach 4: 16 then 8 planes
    assert multichip_check.halo_bound_cells(case) == 4 * 16 * 16 * (16 + 8) / 2
    case, _ = multichip_check.make_case("sc2d", "cpu")
    # 2 × 2 shards of 16 rows × 32 columns, nsub 2, reach 2
    assert multichip_check.halo_bound_cells(case) == 4 * (20 * 36 + 16 * 32) / 2


@pytest.mark.parametrize("name", ["sc2d", "hcz3d"])
def test_halo_bound_work_prices_cells_by_family(name):
    """Where the work of a cell does not depend on the data, a region costs
    its cells times the family's WORK_PER_CELL."""
    case, _ = multichip_check.make_case(name, "cpu")
    cells = multichip_check.halo_bound_cells(case)
    per_cell = multichip_check.HALO_ENTRIES[case.family].WORK_PER_CELL
    assert multichip_check.halo_bound_work(case) == tuple(
        cells * v for v in per_cell)


def test_shard_and_gather_round_trip():
    """Blocks are new contiguous tensors in mesh order; gather restores the
    global tensor, on a (y, x) mesh and on a z ring."""
    a = torch.arange(2 * 12 * 8, dtype=torch.float64).reshape(2, 12, 8)
    s = sh.shard_lattice(a, _mesh(6, (3, 2), ("y", "x")))
    assert s.spec == (None, "y", "x") and s.shape == (2, 12, 8)
    assert torch.equal(s.blocks[1, 0], a[:, 4:8, 0:4])
    assert all(b.is_contiguous() for b in s.blocks.flat)
    assert torch.equal(s.gather(), a)
    v = torch.arange(3 * 8 * 2 * 2, dtype=torch.float32).reshape(3, 8, 2, 2)
    s3 = sh.shard_lattice(v, _mesh(4, names=("z",)))
    assert s3.spec == (None, "z", None, None)
    assert torch.equal(s3.gather(), v)


def test_halo_entries_refuse_a_narrow_halo():
    """halo < reach·nsub raises in every entry; a wider halo is taken."""
    f = torch.zeros(9, 20, 8)
    m = torch.ones(20, 8)
    with pytest.raises(ValueError, match="reach"):
        sc_fused.step_fused_halo(f, m, tsc.SCParams(), nsub=2, halo=3)
    with pytest.raises(ValueError, match="reach"):
        hcz_fused.step_fused_halo(f, f, m, thcz.HCZParams(), nsub=2,
                                  halo=5)
    with pytest.raises(ValueError, match="reach"):
        fakhari_fused.step_fused_halo(f, f, torch.zeros(2, 20, 8),
                                      tfk.FakhariParams(), nsub=1,
                                      halo=4)
    with pytest.raises(ValueError, match="reach"):
        scrt_fused.step_fused_halo(torch.zeros(9, 8, 20),
                                   trt.SCRTParams(), nsub=2, halo=3)
    with pytest.raises(ValueError, match="reach"):
        hcz3d_fused.step_fused_halo_3d(torch.zeros(19, 20, 4, 4),
                                       torch.zeros(19, 20, 4, 4),
                                       thcz.HCZParams(), nsub=2,
                                       halo=5)
    with pytest.raises(ValueError, match="no interior"):
        sc_fused.step_fused_halo(f, m, tsc.SCParams(), nsub=5, halo=10)
    assert sc_fused.step_fused_halo(f, m, tsc.SCParams(), nsub=1,
                                    halo=7).shape == (9, 6, 8)


def test_halo_entries_refuse_a_device_without_a_kernel():
    f = torch.zeros(9, 12, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        scrt_fused.step_fused_halo(f, trt.SCRTParams(), nsub=1)


def test_sharding_refusals(monkeypatch):
    mesh = _mesh(4, names=("y",))
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard_lattice(torch.zeros(9, 30, 8), mesh)
    f = sh.shard_lattice(torch.zeros(9, 16, 8), mesh)
    with pytest.raises(ValueError, match="does not fit"):
        sh._exchange_axis(f.blocks, 5, 1, "y", mesh)
    # 3·nsub = 6 rows of halo from blocks of 4 rows
    step = sh.make_fused_hcz_step(mesh, thcz.HCZParams(), nsub=2)
    m = sh.shard_lattice(torch.ones(16, 8), mesh, leading=0)
    with pytest.raises(ValueError, match="does not fit"):
        step(f, f, m)
    step1 = sh.make_fused_hcz_step(mesh, thcz.HCZParams(), nsub=1)
    with pytest.raises(ValueError, match="this step takes"):
        step1(f, f, sh.shard_lattice(torch.ones(1, 16, 8), mesh, leading=1))
    with pytest.raises(ValueError, match="axes"):
        sh.make_fused_sc_step_2d(mesh, tsc.SCParams())
    with pytest.raises(ValueError, match="3 state arguments"):
        step1(f, f)
    with pytest.raises(ValueError, match="does not hold"):
        sh.make_mesh(4, shape=(3,), devices=[CPU])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sh.make_mesh(4)
