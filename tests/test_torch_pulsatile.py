"""The pulsatile deformable-vessel model of the PyTorch port and its
kernel wrapper against the JAX package, on the CPU.

Inputs come from the shared ``initialize`` states (both packages build
them bit-identically) or from the port's plain path, and go through the JAX
function and its port counterpart at float64.  Tolerances: atol 1e-12 for
every piece and for every step of a trajectory (the port sums over the
velocity index in XLA's order, so most pieces agree bit for bit; its MRT
takes the Pallas kernel's low-rank form, equal to rounding).  A
free-running N = 64 trajectory is chaotic (staircase wall decisions
amplify rounding, models/pulsatile.py of the JAX package), so over 27 free
steps the port runs the JAX model's dense MRT (``dense_mrt``) and is held
to JAX's op-by-op evaluation (``jax.disable_jit``) at 1e-12; the default
low-rank path is held to it step by step, each step from JAX's own state.
JAX's jitted step rounds differently again (XLA fuses it).

The port's plain path is also held to the Pallas kernel in interpret mode
(float32, one step, the tolerances of tests/test_pallas_pulsatile_full.py);
the CUDA kernel is held to the plain path on the card by
tests/test_torch_pulsatile_fused_gpu.py.
"""
import ctypes
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.core import collision as jcoll
from multiphase_lbm_tpu.core.lattice import D2Q9 as JD2Q9
from multiphase_lbm_tpu.models import pulsatile as jp
from multiphase_lbm_tpu.ops import pallas_pulsatile_full as jpf
from multiphase_lbm_tpu.validation import pulsatile_fullrun as jfull
from multiphase_lbm_tpu.validation import womersley as jwom
from multiphase_lbm_tpu_torch.core import collision as tcoll
from multiphase_lbm_tpu_torch.core.lattice import D2Q9
from multiphase_lbm_tpu_torch.models import pulsatile as tp
from multiphase_lbm_tpu_torch.ops import pulsatile_fused as pf
from multiphase_lbm_tpu_torch.utils.convert import (pulsatile_params_from_jax,
                                                    pulsatile_state_from_numpy)
from multiphase_lbm_tpu_torch.validation import pulsatile_fullrun as tfull
from multiphase_lbm_tpu_torch.validation import womersley as twom

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL = 1e-12


def _params(N=24, **kw):
    """(JAX params, port params) of the reference vessel at ny = N."""
    jpar = jp.PulsatileParams(nx=1 + 10 * (N - 2), ny=N, **kw)
    return jpar, pulsatile_params_from_jax(dataclasses.asdict(jpar))


def _to_jax(st):
    return jp.PulsatileState(*[jnp.asarray(t.numpy()) for t in st])


def _to_torch(js, dtype=torch.float64):
    return pulsatile_state_from_numpy(*[np.asarray(a) for a in js], CPU,
                                      dtype)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.double().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t, float), np.asarray(j, float),
        rtol=0, atol=atol)


def _close_state(ts, js, atol=ATOL):
    for name, a, b in zip(js._fields, ts, js):
        if name == "fluid":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def warm():
    """The N = 24 vessel after 10 plain steps of the port, both sides."""
    jpar, tpar = _params()
    st = tp.run(tp.initialize(tpar, device=CPU), 0, tpar, 10)
    return jpar, tpar, st, _to_jax(st)


# ─── parameters, initial states, conversion ────────────────────────────────
@pytest.mark.parametrize("kw", [{}, dict(is_severed=False),
                                dict(momentum_quirk=False, t_beat=400),
                                dict(pingpong_quirk=False, mrt_basis_quirk=True,
                                     zou_he_corner_closure=True)])
def test_derived_parameters_match_jax(kw):
    jpar, tpar = _params(64, **kw)
    assert dataclasses.asdict(tpar) == dataclasses.asdict(jpar)
    for name in ("pingpong", "mrt_basis_scrambled", "corner_closure", "rho0",
                 "S", "beat", "omega", "pin", "pout", "p_tissue", "p_osc",
                 "t_propagation", "t_start", "t_sever", "y0", "yc"):
        assert getattr(tpar, name) == getattr(jpar, name), name
    with pytest.raises(TypeError):
        pulsatile_params_from_jax({**dataclasses.asdict(jpar), "nsub": 8})


@pytest.mark.parametrize("N", [24, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_initialize_matches_jax(N, dtype):
    jpar, tpar = _params(N)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ts = tp.initialize(tpar, dtype, device=CPU)
    js = jp.initialize(jpar, dtype=jdt)
    for name, a, b in zip(js._fields, ts, js):
        assert a.dtype == (torch.bool if name == "fluid" else dtype), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_rigid_channel_and_conversion_match_jax():
    jpar, tpar = _params(24, deformable=False, is_severed=False,
                         momentum_quirk=False, t_beat=400)
    jpar = dataclasses.replace(jpar, nx=61)
    tpar = dataclasses.replace(tpar, nx=61)
    js = jp.initialize_rigid_channel(jpar, 2.3, 20.7)
    ts = tp.initialize_rigid_channel(tpar, 2.3, 20.7, device=CPU)
    _close_state(ts, js, atol=1e-15)
    back = _to_torch(js)
    assert back.fluid.dtype == torch.bool
    _close_state(back, js, atol=0.0)


def test_physics_initial_geometry():
    """tests/test_pulsatile.py: the severed vessel is closed at the inlet,
    open to radius 2 at the outlet, with solid top and bottom rows."""
    jpar, tpar = _params(64)
    assert tpar.pin == 0.02 and tpar.pout == 0.0
    assert np.isclose(tpar.p_osc, 0.002)
    assert tpar.t_propagation == int((tpar.nx - 1) * np.sqrt(3.0) - 1)
    assert tpar.t_start == 2 * tpar.t_propagation
    fluid = tp.initialize(tpar, device=CPU).fluid.numpy()
    assert fluid[:, 0].sum() == 0
    assert 2 <= fluid[:, -1].sum() <= 6
    assert fluid[0].sum() == 0 and fluid[-1].sum() == 0


# ─── pieces at float64 ─────────────────────────────────────────────────────
def test_pressure_equilibrium_matches_jax():
    rng = np.random.default_rng(3)
    P = rng.uniform(-0.1, 0.3, (12, 17))
    u = rng.standard_normal((2, 12, 17)) * 0.05
    out = tcoll.pressure_equilibrium(torch.as_tensor(P), torch.as_tensor(u),
                                     0.7, D2Q9)
    ref = jcoll.pressure_equilibrium(jnp.asarray(P), jnp.asarray(u), 0.7,
                                     JD2Q9)
    _close(out, ref, atol=1e-15)


def test_geometry_pieces_match_jax(warm):
    jpar, tpar, ts, js = warm
    _close(tp.fobj_from_walls(ts.yr1, ts.yr2, tpar),
           jp.fobj_from_walls(js.yr1, js.yr2, jpar))
    for a, b in zip(tp.border_deltas(ts.F, ts.yr1, ts.yr2, tpar),
                    jp.border_deltas(js.F, js.yr1, js.yr2, jpar)):
        _close(a, b)
    for a, b in zip(tp.move_walls(ts.P, ts.yr1, ts.yr2, tpar),
                    jp.move_walls(js.P, js.yr1, js.yr2, jpar)):
        _close(a, b)


@pytest.mark.parametrize("pingpong", [True, False])
@pytest.mark.parametrize("scrambled", [True, False])
def test_collide_mrt_matches_jax(warm, pingpong, scrambled):
    jpar, tpar, ts, js = warm
    kw = dict(pingpong_quirk=pingpong, mrt_basis_quirk=scrambled)
    _close(tp.collide(ts, dataclasses.replace(tpar, **kw)),
           jp.collide(js, dataclasses.replace(jpar, **kw)))


@pytest.mark.parametrize("pingpong", [True, False])
@pytest.mark.parametrize("scrambled", [True, False])
def test_collide_dense_mrt_matches_jax(warm, pingpong, scrambled):
    """``dense_mrt``: the JAX model's form, g − A·(g − g_eq)."""
    jpar, tpar, ts, js = warm
    kw = dict(pingpong_quirk=pingpong, mrt_basis_quirk=scrambled)
    _close(tp.collide(ts, dataclasses.replace(tpar, **kw), dense_mrt=True),
           jp.collide(js, dataclasses.replace(jpar, **kw)))


def test_collide_bgk_matches_jax(warm):
    jpar, tpar, ts, js = warm
    _close(tp.collide(ts, dataclasses.replace(tpar, collision="bgk")),
           jp.collide(js, dataclasses.replace(jpar, collision="bgk")))


def test_bouzidi_and_stream_match_jax(warm):
    jpar, tpar, ts, js = warm
    gout_t, gout_j = tp.collide(ts, tpar), jp.collide(js, jpar)
    bt = tp.bouzidi(gout_t, ts.F, tp.border_deltas(ts.F, ts.yr1, ts.yr2, tpar),
                    tpar)
    bj = jp.bouzidi(gout_j, js.F, jp.border_deltas(js.F, js.yr1, js.yr2, jpar),
                    jpar)
    _close(bt, bj)
    assert not torch.equal(bt, gout_t)          # links were written
    _close(tp.stream_pull(bt), jp.stream_pull(bj))


@pytest.mark.parametrize("corner", [False, True])
@pytest.mark.parametrize("t", [10, 3000])
def test_zou_he_matches_jax(warm, corner, t):
    """Before the waveforms start and inside them (t_start = 760 here)."""
    jpar, tpar, ts, js = warm
    kw = dict(zou_he_corner_closure=corner)
    _close(tp.zou_he(ts.g_stream, ts.yr1, ts.yr2, t,
                     dataclasses.replace(tpar, **kw)),
           jp.zou_he(js.g_stream, js.yr1, js.yr2, t,
                     dataclasses.replace(jpar, **kw)))


@pytest.mark.parametrize("quirk", [True, False])
def test_macroscopic_matches_jax(warm, quirk):
    jpar, tpar, ts, js = warm
    for a, b in zip(tp.macroscopic(ts.g_stream, ts.fluid,
                                   dataclasses.replace(tpar,
                                                       momentum_quirk=quirk)),
                    jp.macroscopic(js.g_stream, js.fluid,
                                   dataclasses.replace(jpar,
                                                       momentum_quirk=quirk))):
        _close(a, b)


def test_physics_momentum_quirk_offset():
    """tests/test_pulsatile.py: the quirky Ux carries +3·g₀/ρ₀ against the
    true first moment."""
    _, tpar = _params(64)
    st = tp.initialize(tpar, device=CPU)
    P_q, Ux_q, _ = tp.macroscopic(st.g_coll, st.fluid, tpar)
    P_t, Ux_t, _ = tp.macroscopic(
        st.g_coll, st.fluid, dataclasses.replace(tpar, momentum_quirk=False))
    assert torch.equal(P_q, P_t)
    expect = 3.0 * st.g_coll[0] / tpar.rho0 * st.fluid
    _close(Ux_q - Ux_t, expect.numpy(), atol=1e-14)


# ─── reseeding ─────────────────────────────────────────────────────────────
@pytest.fixture(scope="module")
def fresh_case():
    """tests/test_pulsatile.py's many-fresh-cells state: the N = 64 vessel
    after 27 steps, walls moved 3× their next displacement."""
    _, tpar = _params(64)
    st = tp.run(tp.initialize(tpar, device=CPU), 0, tpar, 27)
    yr1m, yr2m = tp.move_walls(st.P, st.yr1, st.yr2, tpar)
    yr1 = st.yr1 + 3.0 * (yr1m - st.yr1)
    yr2 = st.yr2 + 3.0 * (yr2m - st.yr2)
    F_new = tp.fobj_from_walls(yr1, yr2, tpar)
    fluid_new = tp.flags_from_fobj(F_new, tpar)
    fresh = (st.F[1:-1, 1:-1] < 1.0) & (F_new[1:-1, 1:-1] >= 1.0) & fluid_new
    assert 20 < int(fresh.sum()) < tp.RESEED_K
    return tpar, st, F_new, fluid_new


def test_reseed_matches_jax(fresh_case):
    tpar, st, F_new, fluid_new = fresh_case
    jpar = jp.PulsatileParams(**dataclasses.asdict(tpar))
    out = tp.reseed_fresh_nodes(st.g_stream, st.P, st.F, F_new, fluid_new,
                                tpar)
    ref = jax.jit(lambda *a: jp.reseed_fresh_nodes(*a, jpar))(
        *[jnp.asarray(t.numpy()) for t in (st.g_stream, st.P, st.F, F_new,
                                           fluid_new)])
    _close(out, ref)
    assert not torch.equal(out, st.g_stream)


def test_reseed_dense_pass_matches_sequential(fresh_case, monkeypatch):
    """With no order-dependent fill, the dense pass equals the sequential
    pass that order-dependent steps take."""
    tpar, st, F_new, fluid_new = fresh_case
    args = (st.g_stream, st.P, st.F, F_new, fluid_new, tpar)
    dense, n_fresh, dep = tp._reseed(*args)
    assert not dep and n_fresh > 20
    orig = tp._dense_fill

    def every_fill_order_dependent(g, Ffrac, fresh, p):
        val, _ = orig(g, Ffrac, fresh, p)
        return val, fresh

    monkeypatch.setattr(tp, "_dense_fill", every_fill_order_dependent)
    seq, _, dep = tp._reseed(*args)
    assert dep
    _close(dense, seq.numpy(), atol=1e-14)


# ─── trajectories ──────────────────────────────────────────────────────────
def test_step_and_run_match_jax_n64():
    """27 steps at the reference N = 64 from ``initialize`` against JAX's
    op-by-op evaluation: the free run with the dense MRT, by ``step`` and
    by ``run``, and every step of the default path from JAX's own state,
    all within 1e-12 with identical fluid maps."""
    jpar, tpar = _params(64)
    js = jp.initialize(jpar)
    ts0 = tp.initialize(tpar, device=CPU)
    ts = ts0
    for t in range(27):
        with jax.disable_jit():
            js_next = jp.step(js, t, jpar)
        _close_state(tp.step(_to_torch(js), t, tpar), js_next)
        ts = tp.step(ts, t, tpar, dense_mrt=True)
        _close_state(ts, js_next)
        js = js_next
    _close_state(tp.run(ts0, 0, tpar, 27, dense_mrt=True), js)


@pytest.mark.parametrize("case", ["non-deformable", "non-severed", "rigid",
                                  "overflow"])
def test_mode_trajectories_match_jax(case):
    """N = 24: 30 steps of the rigid mode, 27 of the healthy (non-severed)
    vessel, and 50 of the quirk-free rigid channel at 61 × 24; and 4 steps
    of the N = 16 vessel at α = 0.04, whose first step seeds more fresh
    cells than ``RESEED_K`` on an order-dependent step (the overflow
    fill)."""
    if case == "overflow":
        jpar, tpar = _params(16, alpha=0.04)
        js, ts = jp.initialize(jpar), tp.initialize(tpar, device=CPU)
        _, n_fresh, dep = tp._step(ts, 0, tpar)
        assert dep and n_fresh > tp.RESEED_K
        n = 4
    elif case == "rigid":
        jpar, tpar = _params(24, deformable=False, is_severed=False,
                             momentum_quirk=False, t_beat=400)
        jpar = dataclasses.replace(jpar, nx=61)
        tpar = dataclasses.replace(tpar, nx=61)
        js = jp.initialize_rigid_channel(jpar, 2.3, 20.7)
        ts = tp.initialize_rigid_channel(tpar, 2.3, 20.7, device=CPU)
        n = 50
    else:
        kw = (dict(deformable=False, is_severed=False)
              if case == "non-deformable" else dict(is_severed=False))
        jpar, tpar = _params(24, **kw)
        js, ts = jp.initialize(jpar), tp.initialize(tpar, device=CPU)
        n = 30 if case == "non-deformable" else 27
    _close_state(tp.run(ts, 0, tpar, n), jp.run(js, 0, jpar, n))


def test_physics_walls_respond_and_modes_stay_sane():
    """tests/test_pulsatile.py on the port's plain path: the severed vessel
    opens at the inlet, the rigid mode keeps its geometry, the healthy
    vessel's walls stay in bounds."""
    _, tpar = _params(64)
    st0 = tp.initialize(tpar, device=CPU)
    st = tp.run(st0, 0, tpar, 54)
    assert st.yr1[0] < st0.yr1[0] and st.yr2[0] > st0.yr2[0]
    assert bool(torch.isfinite(st.P).all())
    _, rig = _params(64, deformable=False, is_severed=False)
    st0 = tp.initialize(rig, device=CPU)
    st = tp.run(st0, 0, rig, 30)
    assert bool(torch.isfinite(st.P).all())
    assert torch.equal(st.fluid, st0.fluid)
    _, healthy = _params(64, is_severed=False)
    st = tp.run(tp.initialize(healthy, device=CPU), 0, healthy, 54)
    assert bool(torch.isfinite(st.P).all())
    assert bool((st.yr1 > 0.5).all()) and bool((st.yr2 < 63).all())
    assert bool((st.yr2 - st.yr1 > 1.0).all())


def test_plain_step_matches_pallas_interpret():
    """One float32 step of the port's plain path against the Pallas kernel
    in interpret mode (nsub = 1) at the JAX test's own shape, 621 × 64,
    from a 4-step warm state (the two fluid maps agree there)."""
    jpar, tpar = _params(64)
    st = tp.run(tp.initialize(tpar, torch.float32, device=CPU), 0, tpar, 4)
    ref, (n_dep, n_cells) = tp.run_with_diag(st, 4, tpar, 1)
    out, dg = jpf.run_fused_full(_to_jax(st), 4, jpar, 1, nsub=1,
                                 interpret=True)
    tol = {"g_coll": 5e-7, "g_stream": 5e-7, "P": 5e-7, "Ux": 5e-7,
           "Uy": 5e-7, "F": 1e-4, "yr1": 5e-5, "yr2": 5e-5}
    for name, a, b in zip(ref._fields, ref, out):
        if name == "fluid":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert float(np.abs(a.double().numpy()
                                - np.asarray(b, float)).max()) < tol[name]
    assert float(dg[0, 0]) == 0.0 and n_dep == 0
    assert float(dg[1, 0]) == n_cells > 0


# ─── the kernel wrapper on the CPU ─────────────────────────────────────────
def test_wrapper_cpu_path_is_the_plain_path_with_its_counts():
    _, tpar = _params(24)
    st = tp.initialize(tpar, device=CPU)
    before = [t.clone() for t in st]
    out, diag = pf.run_fused_full(st, 0, tpar, 12)
    ref, (n_dep, n_cells) = tp.run_with_diag(st, 0, tpar, 12)
    _close_state(out, _to_jax(ref), atol=0.0)
    assert diag.tolist() == [n_dep, n_cells] and n_cells > 0
    assert all(torch.equal(a, b) for a, b in zip(st, before))


@pytest.mark.parametrize("change", [
    dict(momentum_quirk=False), dict(pingpong_quirk=False),
    dict(mrt_basis_quirk=False), dict(zou_he_corner_closure=True),
    dict(collision="bgk"), dict(deformable=False)])
def test_wrapper_refuses_unsupported_modes(change):
    _, tpar = _params(24)
    st = tp.initialize(tpar, device=CPU)
    with pytest.raises(NotImplementedError):
        pf.run_fused_full(st, 0, dataclasses.replace(tpar, **change), 1)


@pytest.mark.parametrize("bad", ["shape", "dtype", "mixed", "fluid", "layout",
                                 "steps", "device", "type"])
def test_wrapper_rejects_bad_state(bad):
    _, tpar = _params(24)
    st = tp.initialize(tpar, torch.float32, device=CPU)
    err, steps = ValueError, 1
    if bad == "shape":
        st = st._replace(P=st.P[:-1])
    elif bad == "dtype":
        st = tp.PulsatileState(*[t if t.dtype == torch.bool else t.half()
                                 for t in st])
        err = TypeError
    elif bad == "mixed":
        st = st._replace(P=st.P.double())
        err = TypeError
    elif bad == "fluid":
        st = st._replace(fluid=st.fluid.float())
        err = TypeError
    elif bad == "layout":
        st = st._replace(g_coll=st.g_coll.transpose(1, 2).contiguous()
                         .transpose(1, 2))
    elif bad == "steps":
        steps = -1
    elif bad == "device":
        st = st._replace(P=st.P.to("meta"))
    else:
        st, err = tuple(st), TypeError
    with pytest.raises(err):
        pf.run_fused_full(st, 0, tpar, steps)


def test_kernel_constants_follow_the_source_struct():
    src = (Path(pf.__file__).parents[1] / "csrc"
           / "pulsatile_step.cu").read_text()
    body = re.search(r"struct PulsatileConst \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+)(?:\[\d+\])?[,;]",
                       re.sub(r"//[^\n]*", "", body))
    assert names == [n for n, _ in pf._PulsatileConst._fields_]
    _, tpar = _params(64)
    c = pf.kernel_constants(tpar)
    Mr, C = tp.mrt_low_rank(tpar)
    assert c.nrel == len(Mr) == 2          # s8 = 1/τ on the two stresses
    np.testing.assert_array_equal(np.array(c.Mr[:18]), Mr.reshape(-1))
    np.testing.assert_array_equal(np.array(c.C[:18]), C.reshape(-1))
    # the low-rank form is M⁻¹ (S − I) M
    np.testing.assert_allclose(
        C.T @ Mr, jcoll.MRT_M_I_INV @ np.diag(np.asarray(tpar.S) - 1.0)
        @ jcoll.MRT_M_I, atol=1e-15)
    assert (c.y0, c.t_start, c.severed, c.ytop) == (31, 2144, 1, 62.5)
    assert ctypes.sizeof(c) == 2 * 81 * 8 + 13 * 8 + 6 * 4


# ─── validation modules: the port's copies ─────────────────────────────────
def test_validation_tables_match_jax():
    assert twom.MODULE_GATES == jwom.MODULE_GATES
    assert (twom.GATE_STEADY, twom.GATE_OSC) == (jwom.GATE_STEADY,
                                                 jwom.GATE_OSC)
    assert tfull.GATES == jfull.GATES and tfull.GATES_F32 == jfull.GATES_F32
    assert tfull.ORDER_DEP_STEPS_MAX == jfull.ORDER_DEP_STEPS_MAX == 12
    assert (tp.RESEED_K, tp._PAD) == (jp.RESEED_K, jp._PAD)
    y = np.arange(20.0)
    for a, b in zip(twom.analytic_profiles(y, 9.5, 8.0, 0.05, 1.0, 0.01,
                                           1e-6, 2e-6),
                    jwom.analytic_profiles(y, 9.5, 8.0, 0.05, 1.0, 0.01,
                                           1e-6, 2e-6)):
        np.testing.assert_array_equal(a, b)


def test_fullrun_metrics_and_compare_match_jax():
    rng = np.random.default_rng(5)
    sims, golds = [], []
    for i in range(jfull.N_DUMPS):
        P = rng.uniform(0, 0.02, (64, 621))
        Ux = rng.standard_normal((64, 621)) * 1e-3
        fluid = rng.uniform(size=(64, 621)) > 0.4
        t = i * jfull.DUMP_EVERY
        a, b = tfull._metrics(P, Ux, fluid, t), jfull._metrics(P, Ux, fluid, t)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        sims.append(a)
        golds.append(tfull._metrics(P * 1.01, Ux, fluid, t))
    assert tfull.compare(sims, golds) == jfull.compare(sims, golds)
    assert tfull.check(tfull.compare(sims, sims), tfull.GATES_F32)
    if not tfull.GOLD.exists():
        with pytest.raises(FileNotFoundError):
            tfull.golden_metrics()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fullrun_perturbation_and_gated_metrics(dtype):
    """The self-check's initial states differ from the reference case's by
    an ulp or two; the gate holds a subset of GATES_F32 and prints the
    rest."""
    _, tpar = _params(64)
    base = tfull._initial_state(tpar, dtype, CPU, 0, 0)
    st = tfull._initial_state(tpar, dtype, CPU, 1, 3)
    d = (st.g_coll - base.g_coll).abs()
    assert bool((d <= 2 * torch.finfo(dtype).eps * base.g_coll.abs()).all())
    assert bool((d > 0).any()) and torch.equal(st.g_coll, st.g_stream)
    assert all(torch.equal(a, b) for a, b in zip(st[2:], base[2:]))
    assert set(tfull.GATED_F32) < set(tfull.GATES_F32)
    table = dict.fromkeys(tfull.GATES_F32, 0.0) | {"wave_phase_lag_dumps": 0}
    gates = {k: tfull.GATES_F32[k] for k in tfull.GATED_F32}
    assert tfull.check(table, gates, tfull.GATES_F32)
    table[next(k for k in tfull.GATES_F32 if k not in gates)] = 1e9
    assert tfull.check(table, gates, tfull.GATES_F32)
    table[tfull.GATED_F32[0]] = 1e9
    assert not tfull.check(table, gates, tfull.GATES_F32)


def test_validation_runs_end_to_end_on_the_cpu():
    """The two drivers' plumbing at a tiny size (the gates run on the card:
    about 4,000 and 19,000 steps)."""
    P, Ux, Uy, (ym, h, nu), n_settle = twom.run_module_channel(
        nx=21, ny=12, t_beat=8, wall=2.3, device="cpu")
    assert P.shape == (8, 12, 21) and np.isfinite(Ux).all()
    y, m, u_xt, (ym, h), n_settle = twom.run_channel(
        ny=8, nx=4, tau=0.9, t_beat=4, device="cpu")
    assert u_xt.shape == (4, 8) and np.isfinite(u_xt).all()
