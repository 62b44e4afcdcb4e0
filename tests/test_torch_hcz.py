"""HCZ phase-field model (2D), stencils, fused-kernel wrapper and RTI
regression of the PyTorch port against the JAX package, on the CPU.

Inputs come from the shared numpy initial states (both packages build them
bit-identically) or from numpy with a fixed seed, and go through the JAX
function and its port counterpart.  Tolerances: float64 atol 1e-12 over 20
steps (summation order differs: einsum against explicit sums), stencils
atol 1e-13; float32 over 5 steps rtol 3e-5, atol 3e-6 (those of
tests/test_pallas_hcz.py).  Cases run at ω = 1.25 and at the RTI config's
ω = 1.96 as well as ω = 1: at ω = 1 the (1 − ω)·f and (1 − ω)·g terms
vanish, and near ω = 2 the forcing prefactor 1 − ω/2 almost does.

The CUDA kernel itself is held against the plain path on the card by
tests/test_torch_hcz_fused_gpu.py.
"""
import dataclasses
import functools
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.core import lattice as jlat
from multiphase_lbm_tpu.core import stencil as jst
from multiphase_lbm_tpu.io.config import lb_parameters
from multiphase_lbm_tpu.models import hcz as jhcz
from multiphase_lbm_tpu.ops import pallas_hcz
from multiphase_lbm_tpu.validation import rti_reference as jref
from multiphase_lbm_tpu.validation import rti_regression as jrr
from multiphase_lbm_tpu_torch.core import lattice as tlat
from multiphase_lbm_tpu_torch.core import stencil as tst
from multiphase_lbm_tpu_torch.models import hcz as thcz
from multiphase_lbm_tpu_torch.ops import hcz_fused
from multiphase_lbm_tpu_torch.utils.convert import (hcz_params_from_jax,
                                                    hcz_state_from_numpy)
from multiphase_lbm_tpu_torch.validation import rti_reference as tref
from multiphase_lbm_tpu_torch.validation import rti_regression as trr

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

CPU = torch.device("cpu")
DATA = pathlib.Path(__file__).parent.parent / "multiphase_lbm_tpu" / \
    "validation" / "data"
TOL = {torch.float64: dict(rtol=0.0, atol=1e-12),
       torch.float32: dict(rtol=3e-5, atol=3e-6)}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
STEPS = {torch.float64: 20, torch.float32: 5}


def _params(**kw):
    """(JAX params, port params) with the same fields."""
    jp = jhcz.HCZParams(**kw)
    return jp, hcz_params_from_jax(dataclasses.asdict(jp))


def _close(t, j, dtype):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL[dtype])


# ─── stencils ──────────────────────────────────────────────────────────────
STENCILS = ["neighbor_values", "isotropic_gradient", "lattice_laplacian",
            "grad_of_laplacian"]


@pytest.mark.parametrize("mask", ["none", "channel", "random"])
@pytest.mark.parametrize("lat", ["D2Q9", "D3Q19"])
@pytest.mark.parametrize("name", STENCILS)
def test_stencil_matches_jax(name, lat, mask):
    shape = (12, 20) if lat == "D2Q9" else (5, 6, 7)
    rng = np.random.default_rng(11)
    q = rng.standard_normal(shape)
    fluid = None
    if mask == "channel":
        fluid = np.ones(shape, bool)
        fluid[..., 0, :] = fluid[..., -1, :] = False
    elif mask == "random":
        fluid = rng.uniform(size=shape) > 0.3
    jf = None if fluid is None else jnp.asarray(fluid)
    tf = None if fluid is None else torch.as_tensor(fluid)
    out = getattr(tst, name)(torch.as_tensor(q), getattr(tlat, lat), tf)
    ref = getattr(jst, name)(jnp.asarray(q), getattr(jlat, lat), jf)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0.0,
                               atol=1e-13)


# ─── the 2D model ──────────────────────────────────────────────────────────
def _case(geometry, omega, dtype):
    """(JAX params, port params, JAX state, JAX fluid, port state, port
    fluid) of the RTI channel 48 × 194 or the layered channel 50 × 50."""
    if geometry == "rti":
        jp, tp = _params(omega=omega, gravity=-6.25e-6, kappa=0.01)
        st = jhcz.init_rayleigh_taylor(48, 194, jp, dtype=JDT[dtype])
        fluid = jhcz.geometry_channel(48, 194)
    else:
        jp, tp = _params(omega=omega, kappa=0.001, Gx_const=1e-8, gx=1e-6)
        st = jhcz.init_layers(50, 50, jp, dtype=JDT[dtype])
        fluid = jhcz.geometry_channel(50, 50)
    st = jhcz.apply_geometry(st, fluid)
    tst_, tfluid = hcz_state_from_numpy(np.asarray(st[0]), np.asarray(st[1]),
                                        np.asarray(fluid), CPU, dtype)
    return jp, tp, st, fluid, tst_, tfluid


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("omega", [1.0, 1.25, 1.96])
@pytest.mark.parametrize("geometry", ["rti", "layers"])
def test_step_and_run_match_jax(geometry, omega, dtype):
    jp, tp, st, fluid, tst_, tfluid = _case(geometry, omega, dtype)
    for a, b in zip(thcz.step_2d(tst_, tfluid, tp), jhcz.step_2d(st, fluid, jp)):
        _close(a, b, dtype)
    n = STEPS[dtype]
    for a, b in zip(thcz.run(tst_, tfluid, tp, n), jhcz.run(st, fluid, jp, n)):
        _close(a, b, dtype)


@pytest.mark.parametrize("geometry", ["rti", "layers"])
def test_macro_2d_matches_jax(geometry):
    jp, tp, st, fluid, tst_, tfluid = _case(geometry, 1.25, torch.float64)
    st = jhcz.run(st, fluid, jp, 5)
    tst_ = tuple(torch.as_tensor(np.array(a)) for a in st)
    for a, b in zip(thcz.macro_2d(*tst_, tfluid, tp),
                    jhcz.macro_2d(*st, fluid, jp)):
        _close(a, b, torch.float64)


def test_run_matches_golden_snapshot():
    """The port's plain float64 path against the stored 40-step N = 64 RTI
    snapshot that pins the JAX model (tests/test_rti_regression.py)."""
    d = np.load(DATA / "hcz_golden_n64.npz")
    N, ny, steps = (int(v) for v in d["meta"])
    nu, omega, dx, dt = lb_parameters(0.04, N, 3000.0)
    p = thcz.HCZParams(omega=omega, gravity=-0.04 * 0.04 / N, kappa=0.01)
    fluid = thcz.geometry_channel(N, ny, device=CPU)
    st = thcz.apply_geometry(
        thcz.init_rayleigh_taylor(N, ny, p, dtype=torch.float64, device=CPU),
        fluid)
    st = thcz.run(st, fluid, p, steps)
    np.testing.assert_allclose(st[0].numpy(), d["f"], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(st[1].numpy(), d["g"], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_initial_states_bit_identical(dtype):
    jp, tp = _params(omega=1.25)
    pairs = [(thcz.init_rayleigh_taylor(24, 50, tp, dtype=dtype, device=CPU),
              jhcz.init_rayleigh_taylor(24, 50, jp, dtype=JDT[dtype])),
             (thcz.init_layers(20, 30, tp, h_lower=0.25, w_int=3, dtype=dtype,
                               device=CPU),
              jhcz.init_layers(20, 30, jp, h_lower=0.25, w_int=3,
                               dtype=JDT[dtype]))]
    for t, j in pairs:
        for a, b in zip(t, j):
            assert a.dtype == dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        thcz.geometry_channel(24, 50, device=CPU).numpy(),
        np.asarray(jhcz.geometry_channel(24, 50)))


def test_diagnostics_match_jax():
    jp, tp, st, fluid, tst_, tfluid = _case("rti", 1.25, torch.float64)
    st = jhcz.run(st, fluid, jp, 20)
    tst_ = tuple(torch.as_tensor(np.array(a)) for a in st)
    np.testing.assert_allclose(float(thcz.kinetic_energy(tst_, tfluid, tp)),
                               float(jhcz.kinetic_energy(st, fluid, jp)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(thcz.total_phase_mass(tst_)),
                               float(jhcz.total_phase_mass(st)), rtol=1e-13)
    phi = np.asarray(jhcz.order_parameter(st[0]))
    np.testing.assert_array_equal(thcz.order_parameter(tst_[0]).numpy(), phi)
    np.testing.assert_allclose(thcz.rho_of_phi(tst_[0].sum(0), tp).numpy(),
                               np.asarray(jhcz.rho_of_phi(st[0].sum(0), jp)),
                               rtol=0.0, atol=1e-15)
    for ny_fluid in (None, 150):
        assert (thcz.interface_heights(phi, tp, ny_fluid=ny_fluid)
                == jhcz.interface_heights(phi, jp, ny_fluid=ny_fluid))


def test_params_and_state_from_jax():
    jp, tp = _params(omega=1.3, gravity=-1e-5, gx=2e-6, Gx_const=1e-8,
                     kappa=0.02)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    with pytest.raises(TypeError):
        hcz_params_from_jax({**dataclasses.asdict(jp), "nsub": 2})
    st = jhcz.init_rayleigh_taylor(8, 12, jp, dtype=jnp.float32)
    fluid = jhcz.geometry_channel(8, 12)
    (tf, tg), tfluid = hcz_state_from_numpy(np.asarray(st[0]), np.asarray(st[1]),
                                            np.asarray(fluid), CPU,
                                            torch.float32)
    assert tf.dtype == tg.dtype == torch.float32 and tfluid.dtype == torch.bool
    np.testing.assert_array_equal(tg.numpy(), np.asarray(st[1]))
    np.testing.assert_array_equal(tfluid.numpy(), np.asarray(fluid))


# ─── the fused-kernel wrapper on the CPU ───────────────────────────────────
def test_run_fused_cpu_matches_pallas_interpret():
    """The port's run_fused (plain path on a CPU tensor) against the Pallas
    kernel in interpret mode: 128 × 32 RTI channel, ω = 1.25, 3 steps,
    float32."""
    jp, tp = _params(omega=1.25, gravity=-6.25e-6, kappa=0.01)
    st = jhcz.init_rayleigh_taylor(128, 32, jp, dtype=jnp.float32)
    fluid = jhcz.geometry_channel(128, 32)
    f, g = jhcz.apply_geometry(st, fluid)
    fl = fluid.astype(jnp.float32)
    ref = pallas_hcz.run_fused(f, g, fl, jp, 3, tile=16, interpret=True)
    out = hcz_fused.run_fused(torch.as_tensor(np.array(f)),
                              torch.as_tensor(np.array(g)),
                              torch.as_tensor(np.array(fl)), tp, 3)
    for a, b in zip(out, ref):
        _close(a, b, torch.float32)


def test_run_fused_leaves_input_untouched():
    p = thcz.HCZParams(omega=1.25, gravity=-1e-5)
    fluid = thcz.geometry_channel(16, 18, device=CPU)
    f, g = thcz.apply_geometry(
        thcz.init_rayleigh_taylor(16, 18, p, device=CPU), fluid)
    before = (f.clone(), g.clone())
    out = hcz_fused.run_fused(f, g, fluid.float(), p, 2)
    assert out[0].data_ptr() != f.data_ptr() and out[1].data_ptr() != g.data_ptr()
    assert torch.equal(f, before[0]) and torch.equal(g, before[1])


@pytest.mark.parametrize("f_shape,g_shape,dtype,m_shape,m_dtype,err", [
    ((8, 6, 16), (8, 6, 16), torch.float32, (6, 16), torch.float32, ValueError),
    ((9, 6, 16), (9, 6, 16), torch.float16, (6, 16), torch.float32, TypeError),
    ((9, 6, 16), (9, 6, 15), torch.float32, (6, 16), torch.float32, ValueError),
    ((9, 6, 16), (9, 6, 16), torch.float32, (6, 15), torch.float32, ValueError),
    ((9, 6, 16), (9, 6, 16), torch.float32, (6, 16), torch.bool, TypeError),
    ((9, 16), (9, 16), torch.float32, (16,), torch.float32, ValueError),
])
def test_run_fused_rejects_bad_state(f_shape, g_shape, dtype, m_shape, m_dtype,
                                     err):
    f = torch.zeros(f_shape, dtype=dtype)
    g = torch.zeros(g_shape, dtype=dtype)
    m = torch.ones(m_shape, dtype=m_dtype)
    with pytest.raises(err):
        hcz_fused.run_fused(f, g, m, thcz.HCZParams(), 1)


def test_run_fused_rejects_mixed_dtypes_and_layouts():
    f = torch.zeros(9, 6, 16)
    m = torch.ones(6, 16)
    with pytest.raises(ValueError):
        hcz_fused.run_fused(f, f.double(), m, thcz.HCZParams(), 1)
    with pytest.raises(ValueError):
        hcz_fused.run_fused(f.transpose(1, 2).contiguous().transpose(1, 2),
                            f, m, thcz.HCZParams(), 1)
    with pytest.raises(ValueError):
        hcz_fused.run_fused(f, f, m, thcz.HCZParams(), -1)


# ─── physics on the port's plain path (tests/test_hcz.py:21-50) ────────────
@functools.lru_cache(maxsize=None)
def _rt_trajectory():
    """The 48 × 194 RTI channel of tests/test_hcz.py (Re 3000, u_lb 0.04),
    float64, with its state kept at steps 0, 100, 800 and 1500."""
    nu, omega, dx, dt = lb_parameters(0.04, 48, 3000.0)
    p = thcz.HCZParams(omega=omega, gravity=-6.25e-6, kappa=0.01)
    fluid = thcz.geometry_channel(48, 194, device=CPU)
    state = thcz.apply_geometry(
        thcz.init_rayleigh_taylor(48, 194, p, dtype=torch.float64, device=CPU),
        fluid)
    kept = {0: state}
    for a, b in ((0, 100), (100, 800), (800, 1500)):
        state = thcz.run(state, fluid, p, b - a)
        kept[b] = state
    return p, fluid, kept


def test_rt_phase_conservation():
    _, _, kept = _rt_trajectory()
    m0 = float(thcz.total_phase_mass(kept[0]))
    m1 = float(thcz.total_phase_mass(kept[100]))
    assert abs(m1 - m0) / abs(m0) < 5e-10


def test_rt_instability_grows_downward():
    """Heavy on top with gravity: the spike (x = nx/2) falls, the bubble
    (x = 0) rises."""
    p, _, kept = _rt_trajectory()
    s0, b0 = thcz.interface_heights(thcz.order_parameter(kept[0][0]).numpy(), p)
    phi1 = thcz.order_parameter(kept[1500][0]).numpy()
    assert np.isfinite(phi1).all()
    s1, b1 = thcz.interface_heights(phi1, p)
    assert s1 <= s0, (s0, s1)
    assert b1 >= b0, (b0, b1)
    assert (s1 - s0) - (b1 - b0) < 0


def test_rt_energy_finite_and_growing():
    p, fluid, kept = _rt_trajectory()
    e0 = float(thcz.kinetic_energy(kept[0], fluid, p))
    e1 = float(thcz.kinetic_energy(kept[800], fluid, p))
    assert np.isfinite(e1) and e1 > e0


# ─── RTI literature regression ─────────────────────────────────────────────
@pytest.mark.parametrize("name", ["x_bubble_256", "y_bubble_256", "x_spike_256",
                                  "y_spike_256", "x_spike_2048", "y_spike_2048",
                                  "x_bubble_2048", "y_bubble_2048"])
def test_reference_curves_equal_jax(name):
    assert getattr(tref, name) == getattr(jref, name)


def test_archived_2048_trajectory_passes_through_the_port():
    d = np.load(DATA / "rti2048_trajectory.npz")
    assert trr.report(d["t"], d["s"], d["b"], t_end=float(d["t"][-1]),
                      N=2048) == 0
    assert (trr.deviations(d["t"], d["s"], d["b"], 2048)
            == tuple(jrr.compare(d["t"], d[k], *c) for k, c in (
                ("s", (jref.x_spike_2048, jref.y_spike_2048)),
                ("b", (jref.x_bubble_2048, jref.y_bubble_2048))))
            + tuple(jrr.compare_velocity(d["t"], d[k], *c) for k, c in (
                ("s", (jref.x_spike_2048, jref.y_spike_2048)),
                ("b", (jref.x_bubble_2048, jref.y_bubble_2048)))))


def test_run_regression_matches_jax():
    """The driver of the regression at N = 16 to t = 0.3 (120 steps in
    chunks of 20), float32: the same interface heights as the JAX XLA run."""
    jt, js, jb = jrr.run_regression(t_end=0.3, N=16)
    tt, ts, tb = trr.run_regression(t_end=0.3, N=16, device=CPU)
    np.testing.assert_allclose(tt, jt, rtol=1e-15)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tb, jb)
    assert trr.rti_params(16) == hcz_params_from_jax(dataclasses.asdict(
        jhcz.HCZParams(omega=lb_parameters(0.04, 16, 3000.0)[1],
                       gravity=-0.04 * 0.04 / 16, kappa=0.01)))


def test_regression_cli_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trr.main(["0.1", "16"]) != 0
    assert "--device cpu" in capsys.readouterr().err
