"""Fakhari conservative phase-field model and its fused-kernel wrapper in
the PyTorch port against the JAX package, on the CPU.

Inputs come from the shared numpy ``init_bubble`` state (both packages
build h and g bit-identically) or from numpy with a fixed seed, and go
through the JAX function and its port counterpart.  Tolerances: float64
atol 1e-12 over 20 steps (summation order differs: einsum against explicit
sums); float32 against the Pallas kernel in interpret mode rtol 5e-5, atol
5e-6 (those of tests/test_pallas_fakhari.py).  Cases run at the config's
τ = 0.8 (s8 = 1.25, wc = 1.79: no term vanishes) and at τ = 0.55, where
F_μ's (0.5 − τ)/τ is small but not zero.

The CUDA kernel itself is held against the plain path on the card by
tests/test_torch_fakhari_fused_gpu.py.
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.core import collision as jcol
from multiphase_lbm_tpu.core import lattice as jlat
from multiphase_lbm_tpu.models import fakhari as jfk
from multiphase_lbm_tpu.ops import pallas_fakhari
from multiphase_lbm_tpu_torch.core import collision as tcol
from multiphase_lbm_tpu_torch.core import lattice as tlat
from multiphase_lbm_tpu_torch.models import fakhari as tfk
from multiphase_lbm_tpu_torch.ops import fakhari_fused
from multiphase_lbm_tpu_torch.utils.convert import (fakhari_params_from_jax,
                                                    fakhari_state_from_numpy)

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = dict(rtol=0.0, atol=1e-12)
F32 = dict(rtol=5e-5, atol=5e-6)
N = 48


def _params(**kw):
    """(JAX params, port params) with the same fields."""
    jp = jfk.FakhariParams(**kw)
    return jp, fakhari_params_from_jax(dataclasses.asdict(jp))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or F64))


def _case(tau, steps=0, nx=N, ny=40):
    """(JAX params, port params, JAX state, port state) of the bubble at
    ``tau`` after ``steps`` JAX steps, float64."""
    jp, tp = _params(tau=tau)
    st = jfk.init_bubble(nx, ny, jp, dtype=jnp.float64)
    if steps:
        st = jfk.run(st, jp, steps)
    return jp, tp, st, fakhari_state_from_numpy(*st, CPU)


def test_gamma_minus_w_matches_jax():
    u = np.random.default_rng(5).standard_normal((2, 12, 20)) * 0.05
    _close(tcol.gamma_minus_w(torch.as_tensor(u), tlat.D2Q9),
           jcol.gamma_minus_w(jnp.asarray(u), jlat.D2Q9), atol=1e-15)


@pytest.mark.parametrize("tau", [0.8, 0.55])
def test_fields_force_and_velocity_match_jax(tau):
    jp, tp, st, ts = _case(tau, steps=5)
    jf = jfk.derive_fields(st[0], st[1], jp)
    tf = tfk.derive_fields(ts[0], ts[1], tp)
    for a, b in zip(tf[:5], jf[:5]):
        _close(a, b)
    # n = ∇φ/|∇φ| is rounding noise where ∇φ vanishes (in the bulk, where
    # the sharpening term's prefactor vanishes with it): compare it where
    # |∇φ| > 1e-4
    band = np.hypot(*np.asarray(jf.dC)) > 1e-4
    assert band.sum() > 100
    np.testing.assert_allclose(tf.n.numpy()[:, band], np.asarray(jf.n)[:, band],
                               **F64)
    _close(tfk.total_force(ts[1], ts[2], tf, tp),
           jfk.total_force(st[1], st[2], jf, jp))
    _close(tfk.velocity_update(ts[1], ts[2], tf, tp),
           jfk.velocity_update(st[1], st[2], jf, jp))
    for a, b in zip(tfk.collide_stream(*ts, tf, tp),
                    jfk.collide_stream(*st, jf, jp)):
        _close(a, b)


@pytest.mark.parametrize("tau", [0.8, 0.55])
def test_step_and_run_match_jax(tau):
    jp, tp, st, ts = _case(tau)
    for a, b in zip(tfk.step(ts, tp), jfk.step(st, jp)):
        _close(a, b)
    for a, b in zip(tfk.run(ts, tp, 20), jfk.run(st, jp, 20)):
        _close(a, b)


def test_random_state_run_matches_jax():
    """A state away from the bubble's symmetry: φ uniform in (0.05, 0.95),
    random p* and u, 20 steps at τ = 0.7 and mobility 0.05."""
    rng = np.random.default_rng(8)
    jp, tp = _params(tau=0.7, M=0.05)
    w = np.asarray(jlat.D2Q9.w)[:, None, None]
    C = rng.uniform(0.05, 0.95, (24, 32))
    h = w * C[None] * (1.0 + 0.05 * rng.standard_normal((9, 24, 32)))
    g = 0.01 * rng.standard_normal((9, 24, 32))
    u = 0.01 * rng.standard_normal((2, 24, 32))
    out = tfk.run(fakhari_state_from_numpy(h, g, u, CPU), tp, 20)
    ref = jfk.run(tuple(jnp.asarray(a) for a in (h, g, u)), jp, 20)
    for a, b in zip(out, ref):
        _close(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_init_bubble_matches_jax(dtype):
    jp, tp = _params()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    for radius in (None, 7.5):
        ts = tfk.init_bubble(40, 32, tp, radius=radius, dtype=dtype, device=CPU)
        js = jfk.init_bubble(40, 32, jp, radius=radius, dtype=jdt)
        assert all(t.dtype == dtype for t in ts)
        np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js[0]))
        np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
        tol = F64 if dtype == torch.float64 else dict(rtol=0.0, atol=1e-7)
        _close(ts[2], js[2], **tol)


def test_diagnostics_match_jax():
    jp, tp, st, ts = _case(0.8, steps=20)
    np.testing.assert_allclose(float(tfk.total_mass(ts, tp)),
                               float(jfk.total_mass(st, jp)), rtol=1e-14)
    np.testing.assert_allclose(float(tfk.kinetic_energy(ts)),
                               float(jfk.kinetic_energy(st)), rtol=1e-12)
    _close(tfk.phase_field(ts), jfk.phase_field(st), atol=1e-15)
    _close(tfk.pressure(ts), jfk.pressure(st), atol=1e-15)


def test_params_and_state_from_jax():
    jp, tp = _params(sigma=0.02, W=5.0, M=0.03, rhol=0.01, rhoh=2.0, tau=0.6)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    for name in ("s8", "beta", "kappa", "drho3", "wc"):
        assert getattr(tp, name) == getattr(jp, name)
    assert tfk.EPS_C == jfk.EPS_C
    with pytest.raises(TypeError):
        fakhari_params_from_jax({**dataclasses.asdict(jp), "nsub": 3})
    st = jfk.init_bubble(8, 6, jp, dtype=jnp.float32)
    ts = fakhari_state_from_numpy(*st, CPU, torch.float32)
    assert [t.shape for t in ts] == [(9, 6, 8), (9, 6, 8), (2, 6, 8)]
    for a, b in zip(ts, st):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ─── the fused-kernel wrapper on the CPU ───────────────────────────────────
def test_run_fused_cpu_matches_pallas_interpret():
    """The port's run_fused (plain path on a CPU tensor) against the Pallas
    kernel in interpret mode: the 64² bubble, 3 steps, float32."""
    jp, tp = _params()
    st = jfk.init_bubble(64, 64, jp, dtype=jnp.float32)
    ref = pallas_fakhari.run_fused(*st, jp, 3, tile=16, nsub=1, interpret=True)
    out = fakhari_fused.run_fused(*fakhari_state_from_numpy(
        *st, CPU, torch.float32), tp, 3)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32
        _close(a, b, **F32)


def test_run_fused_leaves_input_untouched():
    p = tfk.FakhariParams()
    st = tfk.init_bubble(16, 12, p, device=CPU)
    before = tuple(t.clone() for t in st)
    out = fakhari_fused.run_fused(*st, p, 2)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(out, st))
    assert all(torch.equal(a, b) for a, b in zip(st, before))


@pytest.mark.parametrize("shapes,dtype,err", [
    (((8, 6, 16), (9, 6, 16), (2, 6, 16)), torch.float32, ValueError),
    (((9, 6, 16), (9, 6, 16), (3, 6, 16)), torch.float32, ValueError),
    (((9, 6, 16), (9, 6, 15), (2, 6, 16)), torch.float32, ValueError),
    (((9, 6, 16), (9, 6, 16), (2, 6, 15)), torch.float32, ValueError),
    (((9, 96), (9, 96), (2, 96)), torch.float32, ValueError),
    (((9, 6, 16), (9, 6, 16), (2, 6, 16)), torch.float16, TypeError),
])
def test_run_fused_rejects_bad_state(shapes, dtype, err):
    h, g, u = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises(err):
        fakhari_fused.run_fused(h, g, u, tfk.FakhariParams(), 1)


def test_run_fused_rejects_mixed_dtypes_layouts_and_steps():
    h = torch.zeros(9, 6, 16)
    u = torch.zeros(2, 6, 16)
    p = tfk.FakhariParams()
    with pytest.raises(ValueError):
        fakhari_fused.run_fused(h, h, u.double(), p, 1)
    with pytest.raises(ValueError):
        fakhari_fused.run_fused(h.transpose(1, 2).contiguous().transpose(1, 2),
                                h, u, p, 1)
    with pytest.raises(ValueError):
        fakhari_fused.run_fused(h, h, u, p, -1)
    with pytest.raises(TypeError):
        fakhari_fused.run_fused(h.numpy(), h, u, p, 1)


def test_kernel_constants_follow_the_source_struct():
    """The ctypes mirror lists the fields of ``struct FakhariConst`` in the
    CUDA source in the same order, and carries the plain path's float64
    constants."""
    src = (Path(fakhari_fused.__file__).parents[1] / "csrc"
           / "fakhari_step.cu").read_text()
    body = re.search(r"struct FakhariConst \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+)[,;]", re.sub(r"//[^\n]*", "", body))
    assert names == [n for n, _ in fakhari_fused._FakhariConst._fields_]
    p = tfk.FakhariParams(tau=0.55)
    c = fakhari_fused.kernel_constants(p)
    assert (c.fac, c.s8, c.wc, c.four_beta) == ((0.5 - p.tau) / p.tau, p.s8,
                                                p.wc, 4.0 * p.beta)


# ─── physics on the port's plain path (tests/test_fakhari.py) ──────────────
def test_phase_field_conserved():
    """Conservative phase field: Σφ is invariant to rounding over 100 steps
    of the 48² bubble at density ratio 1000, float64."""
    p = tfk.FakhariParams()
    st = tfk.init_bubble(N, N, p, dtype=torch.float64, device=CPU)
    m0 = float(tfk.phase_field(st).sum())
    st = tfk.run(st, p, 100)
    assert all(bool(torch.isfinite(t).all()) for t in st)
    assert abs(float(tfk.phase_field(st).sum()) - m0) / m0 < 1e-12
    C = tfk.phase_field(st).numpy()
    assert C[N // 2, N // 2] < 0.05 and C[2, 2] > 0.95
