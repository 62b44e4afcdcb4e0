"""The combustion model of the PyTorch port, its I/O and its kernel wrapper
against the JAX package, on the CPU.

Inputs are made with numpy from a fixed seed, or from the port's plain
path, and go through the JAX function and its port counterpart.
Tolerances: the pieces of the step at float64 on random positive states to
1e-13 (summation order differs: einsum against explicit sums); the
diagnostics and the four output writers byte for byte; float32 against the
Pallas kernel in interpret mode rtol 2e-4, atol 5e-6 (those of
tests/test_pallas_combustion.py).  The step in every branch over 20 steps
is in tests/test_torch_combustion_step.py and _step_mrt.py, the two-stage
run in tests/test_torch_combustion_staged.py (apart so that the tier-1
run's workers take them in parallel); the CUDA kernel is held against the
plain path on the card by tests/test_torch_combustion_fused_gpu.py.
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.io import checkpoint as jckpt
from multiphase_lbm_tpu.models import combustion as jcb
from multiphase_lbm_tpu.ops import pallas_combustion
from multiphase_lbm_tpu_torch.io import checkpoint as tckpt
from multiphase_lbm_tpu_torch.models import combustion as tcb
from multiphase_lbm_tpu_torch.ops import combustion_fused as cf
from multiphase_lbm_tpu_torch.utils.convert import (
    combustion_params_from_jax, combustion_state_from_numpy)
from multiphase_lbm_tpu_torch.validation import combustion_reference

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

CPU = torch.device("cpu")
TOPOLOGIES = {
    "channel": dict(nx=137, ny=45),
    "channel-freeslip": dict(nx=137, ny=45, y_freeslip=True),
    "channel-no-obstacles": dict(nx=64, ny=24, with_obstacles=False),
    "cavity": dict(nx=64, ny=32, topology="cavity", u_lid=0.05),
    "couette": dict(nx=64, ny=32, topology="couette", u_lid=0.04),
    "poiseuille": dict(nx=64, ny=32, topology="poiseuille", dpdx=1e-6,
                       tau_flow=0.8),
}


def _params(**kw):
    """(JAX params, port params) with the same fields."""
    jp = jcb.CombustionParams(**kw)
    return jp, combustion_params_from_jax(dataclasses.asdict(jp))


def _close(t, j, atol=1e-13):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0.0, atol=atol)


def _random_pops(rng, ny, nx, lo=0.01, hi=0.2):
    return rng.uniform(lo, hi, (9, ny, nx))


def _same(a, b):
    """Equal element for element, NaN where the other has NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def test_tables_equal_jax():
    for name in ("C", "W", "OPP", "M_MAT", "M_INV"):
        np.testing.assert_array_equal(getattr(tcb, name), getattr(jcb, name),
                                      err_msg=name)
    assert tcb.C.dtype == jcb.C.dtype and tcb.OPP.dtype == jcb.OPP.dtype
    assert (tcb.BULK, tcb.WALL, tcb.SPECULAR, tcb.OBSTACLE) == (
        jcb.BULK, jcb.WALL, jcb.SPECULAR, jcb.OBSTACLE)


def test_params_equal_jax():
    for kw in ({}, dict(conjugate_heat=False), dict(conj_scheme="guo2015"),
               dict(tau_flow=0.8, w_e=1.1, w_eps=1.2, w_q=1.3)):
        jp, tp = _params(**kw)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert tp.scheme == jp.scheme and tp.sigma == jp.sigma
        for a, b in zip(tp.S_vectors(), jp.S_vectors()):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        combustion_params_from_jax({"nx": 10, "nsub": 2})


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_geometry_and_static_tables_equal_jax(topo):
    jp, tp = _params(**TOPOLOGIES[topo])
    jflags, jfs = jcb.build_geometry(jp)
    tflags, tfs = tcb.build_geometry(tp)
    np.testing.assert_array_equal(tflags, jflags)
    assert tflags.dtype == jflags.dtype
    np.testing.assert_array_equal(tfs, jfs)
    jtab = jcb.build_static_tables(jflags, jp)
    ttab = tcb.build_static_tables(tflags, tp)
    assert sorted(ttab) == sorted(jtab)
    for key in jtab:
        np.testing.assert_array_equal(ttab[key], jtab[key], err_msg=key)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_initialize_equals_jax(dtype):
    jp, tp = _params(nx=137, ny=45, Y_O2_ini=0.22, Y_CO2_ini=0.01)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    rng = np.random.default_rng(3)
    f_restart = _random_pops(rng, 45, 137)
    for kw in (dict(), dict(T_solid=1.8), dict(f_restart=f_restart)):
        jst = jcb.initialize(jp, dtype=jdt, **kw)
        tst = tcb.initialize(tp, dtype, device=CPU, **kw)
        assert tst._fields == jst._fields
        for t, j in zip(tst, jst):
            assert t.dtype == dtype
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_macros_equilibrium_mrt_gradient_equal_jax():
    rng = np.random.default_rng(5)
    jp, tp = _params(nx=137, ny=45, tau_flow=0.8, w_e=1.1, w_eps=1.2,
                     w_q=1.3)
    f = _random_pops(rng, 45, 137)
    flags, _ = tcb.build_geometry(tp)
    jtab = jcb.build_static_tables(flags, jp)
    ttab = tcb.build_static_tables(flags, tp)
    tf = torch.as_tensor(f)
    jrho, ju = jcb.macro_flow(jnp.asarray(f))
    trho, tu = tcb.macro_flow(tf)
    _close(trho, jrho)
    _close(tu, ju)
    _close(tcb.macro_scalar(tf), jcb.macro_scalar(jnp.asarray(f)))
    usqr = 1.5 * (tu[0] ** 2 + tu[1] ** 2)
    eq = tcb._equilibrium(trho, tu, usqr)
    _close(eq, jcb._equilibrium(jrho, ju, jnp.asarray(usqr.numpy())))
    for S in tp.S_vectors():
        _close(tcb._mrt(tf, eq, S),
               jcb._mrt(jnp.asarray(f), jnp.asarray(eq.numpy()), S))
    q = rng.uniform(0.5, 1.5, (45, 137))
    for t, j in zip(tcb._central_gradient(torch.as_tensor(q), ttab),
                    jcb._central_gradient(jnp.asarray(q), jtab)):
        _close(t, j)


def test_flow_outlet_equals_jax():
    rng = np.random.default_rng(7)
    jp, tp = _params(nx=40, ny=20, u_inlet=0.05)
    f = _random_pops(rng, 20, 40)
    _close(tcb.apply_flow_outlet(torch.as_tensor(f), tp),
           jcb.apply_flow_outlet(jnp.asarray(f), jp))


@pytest.mark.parametrize("species", [True, False])
def test_scalar_bcs_equal_jax(species):
    rng = np.random.default_rng(11)
    jp, tp = _params(nx=40, ny=20)
    g = _random_pops(rng, 20, 40)
    f_bc = _random_pops(rng, 20, 40)
    amp = 0.22 if species else 1.0
    out = tcb.apply_scalar_bcs(torch.as_tensor(g), amp, tp, species=species,
                               f_bc=torch.as_tensor(f_bc))
    ref = jcb.apply_scalar_bcs(jnp.asarray(g), amp, jp, species=species,
                               f_bc=jnp.asarray(f_bc))
    _close(out, ref)
    assert not torch.equal(out, torch.as_tensor(g))


def test_conjugate_bc_and_interface_fractions_equal_jax():
    rng = np.random.default_rng(13)
    jp, tp = _params(nx=137, ny=45)
    flags, _ = tcb.build_geometry(tp)
    jtab = jcb.build_static_tables(flags, jp)
    ttab = tcb.build_static_tables(flags, tp)
    gT = _random_pops(rng, 45, 137)
    gc = _random_pops(rng, 45, 137)
    out = tcb.apply_conjugate_bc(torch.as_tensor(gT), torch.as_tensor(gc),
                                 ttab, tp)
    _close(out, jcb.apply_conjugate_bc(jnp.asarray(gT), jnp.asarray(gc),
                                       jtab, jp))
    assert not torch.equal(out, torch.as_tensor(gT))
    T = rng.uniform(0.9, 2.0, (45, 137))
    T[0, :4] = -1.0                      # below the 1e-2 floor
    Y1 = rng.uniform(0.0, 0.25, (45, 137))
    Y2 = rng.uniform(0.0, 0.05, (45, 137))
    for t, j in zip(
            tcb.interface_mass_fractions(*map(torch.as_tensor, (T, Y1, Y2)),
                                         ttab, tp),
            jcb.interface_mass_fractions(*map(jnp.asarray, (T, Y1, Y2)),
                                         jtab, jp)):
        _close(t, j)


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_streaming_equals_jax(topo):
    rng = np.random.default_rng(17)
    jp, tp = _params(**TOPOLOGIES[topo])
    flags, f_solid = tcb.build_geometry(tp)
    ny, nx = flags.shape
    jtab = jcb.build_static_tables(flags, jp)
    ttab = tcb.build_static_tables(flags, tp)
    post = _random_pops(rng, ny, nx)
    post_s = _random_pops(rng, ny, nx)
    g_old = _random_pops(rng, ny, nx)
    Yk = rng.uniform(0.0, 0.25, (9, ny, nx))
    _close(tcb.stream_flow(torch.as_tensor(post), f_solid, ttab),
           jcb.stream_flow(jnp.asarray(post), f_solid, jtab))
    for pp_t, pp_j in ((tp, jp),
                       (dataclasses.replace(tp, solid_reaction=False),
                        dataclasses.replace(jp, solid_reaction=False))):
        _close(tcb.stream_species(torch.as_tensor(post), torch.as_tensor(Yk),
                                  ttab, pp_t),
               jcb.stream_species(jnp.asarray(post), jnp.asarray(Yk), jtab,
                                  pp_j))
    for scheme in ("li2014", "none"):
        pt = dataclasses.replace(tp, conj_scheme=scheme)
        pj = dataclasses.replace(jp, conj_scheme=scheme)
        for t, j in zip(
                tcb.stream_temperature(*map(torch.as_tensor,
                                            (post, post_s, g_old)), ttab, pt),
                jcb.stream_temperature(*map(jnp.asarray,
                                            (post, post_s, g_old)), jtab, pj)):
            _close(t, j)


def _state(p, steps=6, dtype=torch.float64):
    """The hazard-free warm state: T_solid = 1.8, Y_O2_ini as ``p`` says,
    one first step and ``steps − 1`` more on the port's plain path."""
    flags, _ = tcb.build_geometry(p)
    st = tcb.initialize(p, dtype, T_solid=1.8, flags=flags, device=CPU)
    return tcb.run(st, p, steps, first_step=True)


def test_defined_values_hold_every_finite_cell():
    """defined_values keeps each field where the model defines it: finite
    there, and the forcing terms are non-finite at every solid cell (a check
    over all cells could not pass)."""
    tp = tcb.CombustionParams(nx=137, ny=45, Y_O2_ini=0.22)
    st = _state(tp)
    flags, _ = tcb.build_geometry(tp)
    vals = tcb.defined_values(st, flags)
    assert list(vals) == list(tcb.CombustionState._fields[:8])
    assert all(bool(torch.isfinite(v).all()) for v in vals.values())
    solid = torch.as_tensor(flags != tcb.BULK)
    n_bulk, n_keep = int((~solid).sum()), int((flags != tcb.WALL).sum())
    for name in ("F_O2_prev", "F_CO2_prev", "F_T_prev"):
        assert vals[name].shape == (9, n_bulk)
        assert not bool(torch.isfinite(getattr(st, name)[:, solid]).any()), name
    assert vals["f"].shape == vals["gO2"].shape == (9, n_keep)
    assert vals["gT"].shape == vals["g_coll"].shape == st.gT.shape


def test_diagnostics_and_writers_equal_jax(tmp_path):
    jp, tp = _params(nx=137, ny=45, Y_O2_ini=0.22)
    st = _state(tp)
    arrs = [t.numpy() for t in st]
    jst = jcb.CombustionState(*map(jnp.asarray, arrs))
    tst = combustion_state_from_numpy(*arrs, device=CPU)
    assert all(_same(a, b) for a, b in zip(tst, st))
    flags, _ = tcb.build_geometry(tp)
    jtab = jcb.build_static_tables(flags, jp)
    ttab = tcb.build_static_tables(flags, tp)
    np.testing.assert_allclose(float(tcb.kinetic_energy(tst, ttab)),
                               float(jcb.kinetic_energy(jst, jtab)),
                               rtol=1e-13)
    np.testing.assert_allclose(float(tcb.thermal_energy(tst, ttab, tp)),
                               float(jcb.thermal_energy(jst, jtab, jp)),
                               rtol=1e-13)
    for t, j in zip(tcb.mass_flux_audit(tst, ttab, tp),
                    jcb.mass_flux_audit(jst, jtab, jp)):
        assert np.isfinite(float(t))
        np.testing.assert_allclose(float(t), float(j), rtol=1e-12,
                                   atol=1e-18)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    for d, mod, s, tab, p in ((jdir, jcb, jst, jtab, jp),
                              (tdir, tcb, tst, ttab, tp)):
        d.mkdir()
        mod.save_profiles(d, s, tab, p)
        mod.save_slice(d, s, p)
        mod.middleline(d, s, tab, p, t_ph=0.002)
        mod.conservation_audit(d, s, tab, p)
    names = sorted(x.name for x in jdir.iterdir())
    assert sorted(x.name for x in tdir.iterdir()) == names
    assert len(names) == 18
    for n in names:
        assert (tdir / n).read_bytes() == (jdir / n).read_bytes(), n


def test_flow_field_txt_round_trips_jax(tmp_path):
    rng = np.random.default_rng(19)
    f = np.round(_random_pops(rng, 7, 11), 12)    # exact at 15 digits
    jckpt.save_flow_field_txt(tmp_path / "jax.dat", f)
    back = tckpt.load_flow_field_txt(tmp_path / "jax.dat")
    np.testing.assert_array_equal(back, jckpt.load_flow_field_txt(
        tmp_path / "jax.dat"))
    np.testing.assert_array_equal(back, f)
    tckpt.save_flow_field_txt(tmp_path / "torch.dat", torch.as_tensor(f))
    assert ((tmp_path / "torch.dat").read_bytes()
            == (tmp_path / "jax.dat").read_bytes())
    with pytest.raises(ValueError):
        tckpt.load_flow_field_txt(tmp_path / "jax.dat", q=19)


# ─── the kernel wrapper on the CPU ─────────────────────────────────────────
def test_run_fused_cpu_matches_pallas_interpret():
    """The port's run_fused (plain path on a CPU tensor) against the Pallas
    kernel in interpret mode: 128 × 48, float32, 2 steps, nsub = 1, from a
    warm state with the reaction live."""
    jp, tp = _params(nx=128, ny=48, Y_O2_ini=0.22)
    st = _state(tp, dtype=torch.float32)
    jst = jcb.CombustionState(*(jnp.asarray(t.numpy()) for t in st))
    ref = pallas_combustion.run_fused(jst, jp, 2, nsub=1, interpret=True)
    out = cf.run_fused(st, tp, 2)
    assert out.f.dtype == torch.float32
    flags, _ = tcb.build_geometry(tp)
    keep = (flags == tcb.BULK) | (flags == tcb.OBSTACLE)
    for name in ("f", "gO2", "gCO2", "gT"):
        a = getattr(out, name).numpy()[:, keep]
        b = np.asarray(getattr(ref, name))[:, keep]
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-6, err_msg=name)


def test_run_fused_cpu_modes_and_input_untouched():
    tp = tcb.CombustionParams(nx=64, ny=24, Y_O2_ini=0.22,
                              with_obstacles=False)
    st = _state(tp, steps=2)
    before = [t.clone() for t in st]
    first, _ = tcb.make_step(tp, first_step=True)
    ref = st
    for _ in range(3):
        ref = first(ref)
    out = cf.run_fused(st, tp, 3, all_first_steps=True)
    assert all(_same(a, b) for a, b in zip(out, ref))
    out = cf.run_fused(st, tp, 3, first_step=True)
    ref = tcb.run(st, tp, 3, first_step=True)
    assert all(_same(a, b) for a, b in zip(out, ref))
    out = cf.run_fused(st, tp, 2, konv=False)
    assert _same(out.gT, st.gT)
    assert _same(out.f, tcb.run(st, tp, 2, konv=False).f)
    assert all(_same(a, b) for a, b in zip(st, before))


@pytest.mark.parametrize("bad", [
    dict(conj_scheme="guo2015"), dict(conj_scheme="huber2015"),
    dict(temperature_coupling=True), dict(y_freeslip=True)])
def test_check_params_refuses_what_the_kernel_lacks(bad):
    p = tcb.CombustionParams(nx=64, ny=32, **bad)
    assert not cf.supported(p) and cf.unsupported(p)
    with pytest.raises(NotImplementedError):
        cf.check_params(p)
    st = tcb.initialize(p, torch.float32, device=CPU)
    with pytest.raises(NotImplementedError):
        cf.run_fused(st, p, 1)
    jp = jcb.CombustionParams(nx=64, ny=32, **bad)
    assert not pallas_combustion.supported(jp)


def test_check_params_admits_what_the_kernel_covers():
    for kw in (dict(), dict(conj_scheme="none"), dict(conjugate_heat=False),
               dict(topology="cavity"), dict(topology="couette", nx=64),
               dict(topology="poiseuille", dpdx=1e-6, nx=64)):
        p = tcb.CombustionParams(**kw)
        assert cf.supported(p)
        assert pallas_combustion.supported(jcb.CombustionParams(**kw))


@pytest.mark.parametrize("change,err", [
    (lambda s: s._replace(f=s.f.float()), TypeError),
    (lambda s: s._replace(gO2=s.gO2[:, :-1].contiguous()), ValueError),
    (lambda s: s._replace(q_heat=s.q_heat[None]), ValueError),
    (lambda s: s._replace(gT=s.gT.transpose(1, 2).contiguous()
                          .transpose(1, 2)), ValueError),
    (lambda s: s._replace(g_coll=s.g_coll.numpy()), TypeError),
    (lambda s: tuple(s), TypeError),
])
def test_run_fused_rejects_bad_state(change, err):
    p = tcb.CombustionParams(nx=20, ny=12, with_obstacles=False)
    st = tcb.initialize(p, device=CPU)
    with pytest.raises(err):
        cf.run_fused(change(st), p, 1)
    with pytest.raises(ValueError):
        cf.run_fused(st, p, -1)


def test_kernel_inputs_follow_the_source():
    src = (Path(cf.__file__).parents[1] / "csrc"
           / "combustion_step.cu").read_text()
    body = re.search(r"struct CombustionConst \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+)(?:\[\d+\])?[,;]",
                       re.sub(r"//[^\n]*", "", body))
    assert names == [n for n, _ in cf._CombustionConst._fields_]
    p = tcb.CombustionParams(nx=64, ny=32, topology="cavity", u_lid=0.05,
                             tau_flow=0.8, w_e=1.1)
    tb = cf.kernel_tables(p, CPU, torch.float64)
    flags, f_solid = tcb.build_geometry(p)
    tab = tcb.build_static_tables(flags, p)
    assert torch.equal(tb["flags"], torch.as_tensor(flags))
    np.testing.assert_array_equal(tb["ckn"].numpy(), tab["ck_n"])
    rebuilt = np.zeros_like(f_solid)
    rebuilt[:, :, 0] = tb["fs_col"].numpy()
    rebuilt[:, -1, 1:] = tb["fs_row"].numpy()[:, 1:]
    np.testing.assert_array_equal(rebuilt, f_solid)
    S = p.S_vectors()[0]
    np.testing.assert_array_equal(tb["mats"][0].numpy(),
                                  tcb.M_INV @ np.diag(S) @ tcb.M_MAT)
    c = cf.kernel_constants(p, konv=True)
    assert (c.io, c.konv, c.li2014, c.body_force) == (0, 1, 1, 0)
    assert c.conj_a == (1 - p.sigma) / (1 + p.sigma) == -c.conj_neg_a


# ─── the slice as a whole: the C++ capture through the plain path ─────────
def test_plain_path_matches_the_cpp_capture():
    """The gate of tests/test_combustion_parity.py on the port's plain
    float64 path (128 × 48, every step in the binary's first_step mode,
    every field of FIELDS at steps 100-500)."""
    assert combustion_reference.FIELDS == {
        "Density": (1e-5, False), "velocity_X": (1e-6, False),
        "velocity_Y": (1e-6, False), "Temperature": (1e-5, True),
        "mass_fraction_O2": (2e-6, False), "mass_fraction_CO2": (2e-6, False)}
    rows = combustion_reference.compare(device=CPU)
    assert sorted(rows) == [100, 200, 300, 400, 500]
    assert combustion_reference.within(rows), rows
