"""HCZ phase-field model (3D, D3Q19) and its fused-kernel wrapper in the
PyTorch port against the JAX package, on the CPU.

Tolerances: float64 atol 1e-12 over 10 steps (summation order differs);
float32 against the Pallas kernel in interpret mode rtol 5e-5, atol 5e-6
(those of tests/test_pallas_hcz3d.py).  Cases run at ω = 1.2 as well as
ω = 1, where the (1 − ω) terms vanish.  The CUDA kernel itself is held
against the plain path on the card by tests/test_torch_hcz_fused_gpu.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.models import hcz as jhcz
from multiphase_lbm_tpu.ops import pallas_hcz3d
from multiphase_lbm_tpu_torch.models import hcz as thcz
from multiphase_lbm_tpu_torch.ops import hcz3d_fused
from multiphase_lbm_tpu_torch.utils.convert import (hcz_params_from_jax,
                                                    hcz_state_from_numpy)

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 16


def _case(omega, gravity=0.0, dtype=torch.float64):
    jp = jhcz.HCZParams(omega=omega, kappa=5e-4, gravity=gravity)
    tp = hcz_params_from_jax(dataclasses.asdict(jp))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    st = jhcz.init_droplet_3d(N, N, N, jp, radius=5.0, dtype=jdt)
    fluid = jhcz.geometry_periodic_3d(N, N, N)
    tst, tfluid = hcz_state_from_numpy(np.asarray(st[0]), np.asarray(st[1]),
                                       np.asarray(fluid), CPU, dtype)
    return jp, tp, st, fluid, tst, tfluid


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("omega,gravity", [(1.0, 0.0), (1.2, 0.0),
                                           (1.2, -1e-5)])
def test_step_and_run_match_jax(omega, gravity):
    jp, tp, st, fluid, tst, tfluid = _case(omega, gravity)
    for a, b in zip(thcz.step_3d(tst, tfluid, tp),
                    jhcz.step_3d(st, fluid, jp, jhcz.D3Q19)):
        _close(a, b, rtol=0.0, atol=1e-12)
    out = thcz.run(tst, tfluid, tp, 10, lattice=thcz.D3Q19, three_d=True)
    ref = jhcz.run(st, fluid, jp, 10, lattice=jhcz.D3Q19, three_d=True)
    for a, b in zip(out, ref):
        _close(a, b, rtol=0.0, atol=1e-12)


def test_macro_3d_and_energy_match_jax():
    jp, tp, st, fluid, tst, tfluid = _case(1.2, -1e-5)
    st = jhcz.run(st, fluid, jp, 5, lattice=jhcz.D3Q19, three_d=True)
    tst = tuple(torch.as_tensor(np.array(a)) for a in st)
    for a, b in zip(thcz.macro_3d(*tst, tfluid, tp),
                    jhcz.macro_3d(*st, fluid, jp, jhcz.D3Q19)):
        _close(a, b, rtol=0.0, atol=1e-12)
    np.testing.assert_allclose(
        float(thcz.kinetic_energy(tst, tfluid, tp, thcz.D3Q19, three_d=True)),
        float(jhcz.kinetic_energy(st, fluid, jp, jhcz.D3Q19, three_d=True)),
        rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_initial_state_bit_identical(dtype):
    jp = jhcz.HCZParams(omega=1.2)
    tp = hcz_params_from_jax(dataclasses.asdict(jp))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    for radius in (None, 3.5):
        t = thcz.init_droplet_3d(12, 10, 8, tp, radius=radius, dtype=dtype,
                                 device=CPU)
        j = jhcz.init_droplet_3d(12, 10, 8, jp, radius=radius, dtype=jdt)
        for a, b in zip(t, j):
            assert a.shape == (19, 8, 10, 12) and a.dtype == dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        thcz.geometry_periodic_3d(12, 10, 8, device=CPU).numpy(),
        np.asarray(jhcz.geometry_periodic_3d(12, 10, 8)))


def test_run_fused_3d_cpu_matches_pallas_interpret():
    """The port's run_fused_3d (plain path on a CPU tensor) against the
    Pallas kernel in interpret mode: 128 × 16 × 16 (nx × ny × nz), tile 4,
    ω = 1.2, 2 steps, float32."""
    jp = jhcz.HCZParams(omega=1.2, kappa=5e-4)
    tp = hcz_params_from_jax(dataclasses.asdict(jp))
    f, g = jhcz.init_droplet_3d(128, 16, 16, jp, radius=5.0,
                                dtype=jnp.float32)
    ref = pallas_hcz3d.run_fused_3d(f, g, jp, 2, tile=4, interpret=True)
    out = hcz3d_fused.run_fused_3d(torch.as_tensor(np.array(f)),
                                   torch.as_tensor(np.array(g)), tp, 2)
    for a, b in zip(out, ref):
        _close(a, b, rtol=5e-5, atol=5e-6)


def test_run_fused_3d_leaves_input_untouched():
    p = thcz.HCZParams(omega=1.2)
    f, g = thcz.init_droplet_3d(8, 8, 8, p, radius=2.5, device=CPU)
    before = (f.clone(), g.clone())
    out = hcz3d_fused.run_fused_3d(f, g, p, 1)
    assert out[0].data_ptr() != f.data_ptr()
    assert torch.equal(f, before[0]) and torch.equal(g, before[1])


@pytest.mark.parametrize("f_shape,g_shape,dtype,err", [
    ((9, 4, 4, 4), (9, 4, 4, 4), torch.float32, ValueError),
    ((19, 4, 4), (19, 4, 4), torch.float32, ValueError),
    ((19, 4, 4, 4), (19, 4, 4, 5), torch.float32, ValueError),
    ((19, 4, 4, 4), (19, 4, 4, 4), torch.int32, TypeError),
])
def test_run_fused_3d_rejects_bad_state(f_shape, g_shape, dtype, err):
    with pytest.raises(err):
        hcz3d_fused.run_fused_3d(torch.zeros(f_shape, dtype=dtype),
                                 torch.zeros(g_shape, dtype=dtype),
                                 thcz.HCZParams(), 1)
