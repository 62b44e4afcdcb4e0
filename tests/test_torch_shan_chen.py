"""Shan–Chen model and fused-kernel wrapper of the PyTorch port against the
JAX package, on the CPU.

Inputs come from the shared numpy ``init_droplet`` / ``init_layers`` (both
packages build them bit-identically) or from numpy with a fixed seed, and
go through the JAX function and its port counterpart.  Tolerances: float64
atol 1e-12 (summation order differs: einsum and matmul against explicit
sums); float32 rtol 2e-5, atol 2e-6 (those of tests/test_pallas_sc.py).
MRT cases run at ω = 1.25 as well as ω = 1: at ω = 1 the rank-2 MRT term
vanishes, so only ω ≠ 1 exercises rows 7 and 8 of the moment basis.

The CUDA kernel itself is held against the plain path on the card by
tests/test_torch_sc_fused_gpu.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.models import shan_chen as jsc
from multiphase_lbm_tpu.ops import pallas_sc
from multiphase_lbm_tpu_torch.models import shan_chen as tsc
from multiphase_lbm_tpu_torch.ops import sc_fused
from multiphase_lbm_tpu_torch.utils.convert import params_from_jax, state_from_numpy

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = {torch.float64: dict(rtol=0.0, atol=1e-12),
       torch.float32: dict(rtol=2e-5, atol=2e-6)}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
NX, NY = 64, 32


def _params(**kw):
    """(JAX params, port params) with the same fields."""
    jp = jsc.SCParams(**kw)
    return jp, params_from_jax(dataclasses.asdict(jp))


def _case(geometry, dtype, jp):
    """Shared initial state: (JAX f, JAX fluid, port f, port fluid)."""
    jdt = JDT[dtype]
    if geometry == "periodic":
        f = jsc.init_droplet(NX, NY, jp, radius=8.0, dtype=jdt)
        fluid = jsc.geometry_periodic(NX, NY)
    elif geometry == "walls":                       # contact-angle problem
        f = jsc.init_droplet(NX, NY, jp, radius=8.0, center=(NX / 2, 5.0),
                             dtype=jdt)
        fluid = jsc.geometry_channel_walls(NX, NY)
        f = jsc.apply_geometry(f, fluid)
    else:                                           # const_g layered flow
        f = jsc.init_layers(NX, NY, jp, dtype=jdt)
        fluid = jsc.geometry_channel_walls(NX, NY)
        f = jsc.apply_geometry(f, fluid)
    tf, tfluid = state_from_numpy(np.asarray(f), np.asarray(fluid), CPU, dtype)
    return f, fluid, tf, tfluid


def _close(t, j, dtype):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("psi_mode,center", [("yuan", True), ("yuan", False),
                                             ("const_g", True),
                                             ("const_g", False)])
def test_sc_force_branches(psi_mode, center, dtype):
    jp, tp = _params(psi_mode=psi_mode, wall_psi_center_branch=center,
                     rho_w=0.2, gravity=1e-5, gx=2e-5, gx_u=1e-6, gy_u=-1e-6,
                     p_shift=0.01 if psi_mode == "const_g" else 0.0)
    rng = np.random.default_rng(0)
    rho = rng.uniform(0.03, 0.3, (NY, NX))
    fluid = np.ones((NY, NX), bool)
    fluid[0] = fluid[-1] = False
    fluid[10:14, 20:26] = False                     # an obstacle
    jF = jsc.sc_force(jnp.asarray(rho, JDT[dtype]), jnp.asarray(fluid), jp)
    tF = tsc.sc_force(torch.as_tensor(rho, dtype=dtype),
                      torch.as_tensor(fluid), tp)
    _close(tF, jF, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("omega", [1.0, 1.25])
@pytest.mark.parametrize("collision", ["bgk", "mrt"])
@pytest.mark.parametrize("geometry", ["periodic", "walls"])
def test_step_and_run_match_jax(geometry, collision, omega, dtype):
    jp, tp = _params(collision=collision, omega=omega, rho_w=0.2)
    f, fluid, tf, tfluid = _case(geometry, dtype, jp)
    _close(tsc.step(tf, tfluid, tp), jsc.step(f, fluid, jp), dtype)
    _close(tsc.run(tf, tfluid, tp, 10), jsc.run(f, fluid, jp, 10), dtype)


def test_layered_const_g_run_matches_jax():
    p0 = jsc.SCParams(TT0=0.95, rhol=0.21, rhog=0.067, rho_w=0.067,
                      psi_mode="const_g", gx_u=1e-6, collision="mrt",
                      omega=1.25)
    jp = dataclasses.replace(p0, p_shift=jsc.compute_p_shift(p0))
    tp = params_from_jax(dataclasses.asdict(jp))
    assert tsc.compute_p_shift(tp) == jp.p_shift
    f, fluid, tf, tfluid = _case("layers", torch.float64, jp)
    _close(tsc.run(tf, tfluid, tp, 10), jsc.run(f, fluid, jp, 10),
           torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_initial_states_bit_identical(dtype):
    jp, tp = _params()
    jdt = JDT[dtype]
    np.testing.assert_array_equal(
        tsc.init_droplet(NX, NY, tp, radius=7.5, center=(30, 4.0),
                         dtype=dtype, device=CPU).numpy(),
        np.asarray(jsc.init_droplet(NX, NY, jp, radius=7.5, center=(30, 4.0),
                                    dtype=jdt)))
    np.testing.assert_array_equal(
        tsc.init_layers(NX, NY, tp, h_lower=0.25, w_int=3, dtype=dtype,
                        device=CPU).numpy(),
        np.asarray(jsc.init_layers(NX, NY, jp, h_lower=0.25, w_int=3,
                                   dtype=jdt)))
    np.testing.assert_array_equal(
        tsc.geometry_channel_walls(NX, NY, device=CPU).numpy(),
        np.asarray(jsc.geometry_channel_walls(NX, NY)))


def test_diagnostics_match_jax():
    jp, tp = _params(collision="mrt", omega=1.25, rho_w=0.2)
    f, fluid, tf, tfluid = _case("walls", torch.float64, jp)
    f = jsc.run(f, fluid, jp, 20)
    tf = torch.as_tensor(np.array(f))
    tol = TOL[torch.float64]
    _close(tsc.u_actual(tf, tfluid, tp), jsc.u_actual(f, fluid, jp),
           torch.float64)
    _close(tsc.node_pressure(tf, tp), jsc.node_pressure(f, jp), torch.float64)
    np.testing.assert_allclose(float(tsc.total_mass(tf, tfluid)),
                               float(jsc.total_mass(f, fluid)), rtol=1e-14)
    np.testing.assert_allclose(float(tsc.kinetic_energy(tf, tfluid, tp)),
                               float(jsc.kinetic_energy(f, fluid, jp)),
                               rtol=1e-12, atol=tol["atol"])
    rho = np.asarray(jsc.density(f))
    assert (tsc.contact_angle(rho, np.asarray(fluid), tp.rhol, tp.rhog)
            == jsc.contact_angle(rho, np.asarray(fluid), jp.rhol, jp.rhog))


@pytest.mark.parametrize("periodic", [True, False])
def test_run_fused_cpu_matches_pallas_interpret(periodic):
    """The port's run_fused (plain path on a CPU tensor) against the Pallas
    kernel in interpret mode: 128×32, MRT at ω = 1.25, 5 steps, float32."""
    jp, tp = _params(collision="mrt", omega=1.25, rho_w=0.2)
    nx, ny = 128, 32
    if periodic:
        f = jsc.init_droplet(nx, ny, jp, radius=6.0, dtype=jnp.float32)
        fluid = jsc.geometry_periodic(nx, ny)
    else:
        f = jsc.init_droplet(nx, ny, jp, radius=6.0, center=(nx / 2, 5.0),
                             dtype=jnp.float32)
        fluid = jsc.geometry_channel_walls(nx, ny)
        f = jsc.apply_geometry(f, fluid)
    fl = fluid.astype(jnp.float32)
    ref = pallas_sc.run_fused(f, fl, jp, 5, tile=8, interpret=True,
                              periodic=periodic)
    out = sc_fused.run_fused(torch.as_tensor(np.array(f)),
                             torch.as_tensor(np.array(fl)), tp, 5,
                             periodic=periodic)
    _close(out, ref, torch.float32)


def test_run_fused_leaves_input_untouched():
    _, tp = _params(collision="mrt", omega=1.25)
    f = tsc.init_droplet(16, 8, tp, radius=3.0, device=CPU)
    before = f.clone()
    out = sc_fused.run_fused(f, torch.ones(8, 16), tp, 2, periodic=True)
    assert out.data_ptr() != f.data_ptr()
    assert torch.equal(f, before)


@pytest.mark.parametrize("extra", [
    dict(psi_mode="const_g", G=-1.0, TT0=0.95, rhol=0.21, rhog=0.067,
         rho_w=0.067, p_shift=0.01, gx_u=1e-6, gy_u=-3e-7),
    dict(gx_u=1e-6), dict(gy_u=1e-6)])
def test_run_fused_takes_const_g_and_node_force(extra):
    """The constant-G ψ and the per-node force, which the Pallas kernel
    refuses, run through run_fused (the plain path on a CPU tensor) and
    match JAX's sc.run: walled channel, MRT at ω = 1.25, 3 steps, float64."""
    jp, tp = _params(collision="mrt", omega=1.25, **extra)
    geometry = "layers" if extra.get("psi_mode") == "const_g" else "walls"
    f, fluid, tf, tfluid = _case(geometry, torch.float64, jp)
    ref = jsc.run(f, fluid, jp, 3)
    out = sc_fused.run_fused(tf, tfluid.to(torch.float32), tp, 3)
    _close(out, ref, torch.float64)


@pytest.mark.parametrize("bad", [dict(psi_mode="bogus"), dict(psi_mode="Yuan"),
                                 dict(psi_mode="constG")])
def test_run_fused_rejects_unsupported_params(bad):
    """A ψ form the kernel does not implement is refused by name."""
    p = tsc.SCParams(**bad)
    f = tsc.init_droplet(16, 8, p, radius=3.0, device=CPU)
    with pytest.raises(NotImplementedError, match=bad["psi_mode"]):
        sc_fused.run_fused(f, torch.ones(8, 16), p, 1)


@pytest.mark.parametrize("f_shape,f_dtype,m_shape,m_dtype,err", [
    ((8, 8, 16), torch.float32, (8, 16), torch.float32, ValueError),
    ((9, 8, 16), torch.float16, (8, 16), torch.float32, TypeError),
    ((9, 8, 16), torch.float32, (8, 15), torch.float32, ValueError),
    ((9, 8, 16), torch.float32, (8, 16), torch.bool, TypeError),
    ((9, 16), torch.float32, (16,), torch.float32, ValueError),
])
def test_run_fused_rejects_bad_state(f_shape, f_dtype, m_shape, m_dtype, err):
    f = torch.zeros(f_shape, dtype=f_dtype)
    m = torch.ones(m_shape, dtype=m_dtype)
    with pytest.raises(err):
        sc_fused.run_fused(f, m, tsc.SCParams(), 1)
