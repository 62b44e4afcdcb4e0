"""Shan–Chen Rayleigh–Taylor model and its fused-kernel wrapper in the
PyTorch port against the JAX package, on the CPU.

Inputs come from the shared numpy ``init_interface`` state (both packages
build it bit-identically) or from numpy with a fixed seed, and go through
the JAX function and its port counterpart.  Tolerances: float64 atol 1e-12
over 20 steps (summation order differs: einsum against explicit sums);
float32 against the Pallas kernel in interpret mode rtol 2e-5, atol 2e-6
(those of tests/test_pallas_scrt.py).  Cases run at ω = 1.25 as well as at
the config's ω = 1 (Re 30.72, u_lb 0.04 at N = 128): at ω = 1 the
(1 − ω)·f term vanishes.

The CUDA kernel itself is held against the plain path on the card by
tests/test_torch_scrt_fused_gpu.py.
"""
import dataclasses
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.io.config import lb_parameters
from multiphase_lbm_tpu.models import hcz as jhcz
from multiphase_lbm_tpu.models import shan_chen_rt as jrt
from multiphase_lbm_tpu.ops import pallas_scrt
from multiphase_lbm_tpu_torch.models import shan_chen_rt as trt
from multiphase_lbm_tpu_torch.ops import scrt_fused
from multiphase_lbm_tpu_torch.utils.convert import (scrt_params_from_jax,
                                                    state_from_numpy)
from multiphase_lbm_tpu_torch.validation import scrt_reference

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = dict(rtol=0.0, atol=1e-12)
F32 = dict(rtol=2e-5, atol=2e-6)
NX = 24
NY = 4 * NX + 2


def _params(**kw):
    """(JAX params, port params) with the same fields."""
    jp = jrt.SCRTParams(**kw)
    return jp, scrt_params_from_jax(dataclasses.asdict(jp))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or F64))


def _case(omega, dtype=torch.float64, steps=0):
    """(JAX params, port params, JAX f, JAX fluid, port f, port fluid) of the
    NX × (4 NX + 2) channel, after ``steps`` JAX steps."""
    jp, tp = _params(omega=omega)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    fluid = jrt.geometry_channel(NX, NY)
    f = jrt.init_interface(NX, NY, jp, dtype=jdt) * fluid[None].astype(jdt)
    if steps:
        f = jrt.run(f, fluid, jp, steps)
    tf, tfluid = state_from_numpy(np.asarray(f), np.asarray(fluid), CPU, dtype)
    return jp, tp, f, fluid, tf, tfluid


@pytest.mark.parametrize("mask", ["channel", "random"])
def test_force_ff_matches_jax(mask):
    """The force with its mirrored reads, on a random density field: the
    channel walls, and a random mask whose solid cells have solid
    neighbours on both sides."""
    rng = np.random.default_rng(21)
    rho = rng.uniform(0.3, 1.3, (18, 16))
    if mask == "channel":
        fluid = np.ones((18, 16), bool)
        fluid[0] = fluid[-1] = False
    else:
        fluid = rng.uniform(size=(18, 16)) > 0.3
    jp, tp = _params(g=-4.5, gravity=-2e-5)
    out = trt.force_ff(torch.as_tensor(rho), torch.as_tensor(fluid), tp)
    ref = jrt.force_ff(jnp.asarray(rho), jnp.asarray(fluid), jp)
    _close(out, ref, atol=1e-14)


@pytest.mark.parametrize("omega", [1.0, 1.25])
def test_step_and_run_match_jax(omega):
    jp, tp, f, fluid, tf, tfluid = _case(omega)
    _close(trt.step(tf, tfluid, tp), jrt.step(f, fluid, jp))
    _close(trt.run(tf, tfluid, tp, 20), jrt.run(f, fluid, jp, 20))


def test_step_with_gravity_matches_jax():
    jp, tp, f, fluid, tf, tfluid = _case(1.25, steps=10)
    for grav in (-3e-5, 0.0):
        _close(trt.step_with_gravity(tf, tfluid, tp, grav),
               jrt.step_with_gravity(f, fluid, jp, grav))
    g = torch.tensor(-3e-5, dtype=torch.float64, requires_grad=True)
    trt.step_with_gravity(tf, tfluid, tp, g).sum().backward()
    assert g.grad is not None and torch.isfinite(g.grad)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_init_interface_and_geometry_match_jax(dtype):
    jp, tp = _params(rhol=1.1, rhog=0.3)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    for nx, ny in ((24, 98), (17, 40)):
        tf = trt.init_interface(nx, ny, tp, dtype=dtype, device=CPU)
        assert tf.dtype == dtype
        np.testing.assert_array_equal(
            tf.numpy(), np.asarray(jrt.init_interface(nx, ny, jp, dtype=jdt)))
        np.testing.assert_array_equal(
            trt.geometry_channel(nx, ny, device=CPU).numpy(),
            np.asarray(jrt.geometry_channel(nx, ny)))


def test_diagnostics_match_jax():
    jp, tp, f, fluid, tf, tfluid = _case(1.0, steps=40)
    _close(trt.density(tf), jrt.density(f), atol=1e-15)
    np.testing.assert_allclose(float(trt.kinetic_energy(tf, tfluid, tp)),
                               float(jrt.kinetic_energy(f, fluid, jp)),
                               rtol=1e-12)
    # the record's spike and bubble rows: the JAX package's PF
    # findInterfaceHeights applied to ρ, the rule the C++ capture's rows
    # follow (tests/test_torch_scrt_reference.py); the JAX SC
    # interface_height follows another
    rho = np.asarray(jrt.density(f))
    cut = SimpleNamespace(phi_l=jp.rhol, phi_g=jp.rhog)
    assert (trt.interface_height(rho, np.asarray(fluid), tp)
            == jhcz.interface_heights(rho, cut))
    assert trt.RHO_FLOOR == jrt.RHO_FLOOR
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp) and tp.tau == jp.tau
    with pytest.raises(TypeError):
        scrt_params_from_jax({**dataclasses.asdict(jp), "nsub": 2})


# ─── the fused-kernel wrapper on the CPU ───────────────────────────────────
@pytest.mark.parametrize("omega", [1.0, 1.25])
def test_run_fused_cpu_matches_pallas_interpret(omega):
    """The port's run_fused (plain path on a CPU tensor) against the Pallas
    kernel in interpret mode: N = 24 (24 × 98), 4 steps, float32."""
    jp, tp, f, fluid, tf, tfluid = _case(omega, torch.float32)
    ref = pallas_scrt.run_fused(f, jp, 4, tile=8, interpret=True, nsub=1)
    out = scrt_fused.run_fused(tf, tp, 4)
    assert out.dtype == torch.float32 and out.shape == (9, NY, NX)
    _close(out, ref, **F32)
    assert bool((out[:, 0] == 0).all()) and bool((out[:, -1] == 0).all())


def test_run_fused_keeps_float64_and_leaves_input_untouched():
    jp, tp, f, fluid, tf, tfluid = _case(1.25)
    before = tf.clone()
    out = scrt_fused.run_fused(tf, tp, 3)
    assert out.dtype == torch.float64 and out.data_ptr() != tf.data_ptr()
    assert torch.equal(tf, before)
    _close(out, jrt.run(f, fluid, jp, 3))


@pytest.mark.parametrize("shape,dtype,err", [
    ((8, 10, 6), torch.float32, ValueError),
    ((9, 2, 6), torch.float32, ValueError),
    ((9, 60), torch.float32, ValueError),
    ((9, 10, 6), torch.float16, TypeError),
    ((9, 10, 6), torch.int32, TypeError),
])
def test_run_fused_rejects_bad_state(shape, dtype, err):
    with pytest.raises(err):
        scrt_fused.run_fused(torch.zeros(shape, dtype=dtype),
                             trt.SCRTParams(), 1)


def test_run_fused_rejects_layouts_and_steps():
    f = torch.zeros(9, 10, 6)
    with pytest.raises(ValueError):
        scrt_fused.run_fused(f.transpose(1, 2), trt.SCRTParams(), 1)
    with pytest.raises(ValueError):
        scrt_fused.run_fused(f, trt.SCRTParams(), -1)
    with pytest.raises(TypeError):
        scrt_fused.run_fused(f.numpy(), trt.SCRTParams(), 1)


def test_kernel_constants_follow_the_source_struct():
    src = (Path(scrt_fused.__file__).parents[1] / "csrc"
           / "scrt_step.cu").read_text()
    body = re.search(r"struct SCRTConst \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+)[,;]", re.sub(r"//[^\n]*", "", body))
    assert names == [n for n, _ in scrt_fused._SCRTConst._fields_]
    p = trt.SCRTParams(omega=1.25, g=-4.0)
    c = scrt_fused.kernel_constants(p)
    assert (c.neg_g, c.src_fac, c.one_minus_omega) == (4.0, 0.375, -0.25)


# ─── the record entry on the CPU ───────────────────────────────────────────
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("omega", [1.0, 1.25])
def test_record_cpu_is_the_plain_record(omega, dtype):
    """On a CPU tensor ``record`` gives exactly the plain functions the
    driver called before the kernel: ``kinetic_energy``, Σρ over the fluid
    and ``interface_height`` (spike at nx/2, bubble at 0), as float64,
    leaving the state as it was."""
    _, tp, _, _, tf, tfluid = _case(omega, dtype, steps=12)
    before = tf.clone()
    rho = trt.density(tf)
    want = [float(trt.kinetic_energy(tf, tfluid, tp)),
            float((rho * tfluid).sum()),
            *trt.interface_height(rho.numpy(), tfluid.numpy(), tp)]
    rec = scrt_fused.record(tf, tfluid, tp)
    assert rec.dtype == torch.float64 and rec.shape == (4,)
    assert rec.tolist() == want
    assert 0 < want[2] < NY - 1 and 0 < want[3] < NY - 1
    assert torch.equal(tf, before)


def test_record_entries_mirror_the_kernel_source():
    """The record entries take the state, ψ scratch, workspace and output,
    then ny and nx, the constants and the cut where the wrapper passes them
    (``tests/test_torch_ops.py`` holds their argument types to the
    signatures)."""
    src = (Path(scrt_fused.__file__).parents[1] / "csrc"
           / "scrt_step.cu").read_text()
    for name in ("scrt_record_f32", "scrt_record_f64"):
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        assert [a.split()[-1].lstrip("*") for a in params.split(",")] == [
            "f", "psi", "ws", "out", "ny", "nx", "consts", "rho_cut",
            "stream"]
    assert re.search(r"constexpr int RECORD_BLOCKS = (\d+);", src).group(1) \
        == str(scrt_fused.RECORD_BLOCKS)


@pytest.mark.parametrize("f_shape,mask_shape,mask_dtype,err", [
    ((9, 10, 6), (10, 7), torch.bool, ValueError),     # mask of another shape
    ((9, 10, 6), (6, 10), torch.bool, ValueError),     # mask transposed
    ((9, 10, 6), (10, 6), torch.float32, TypeError),   # not a bool mask
    ((9, 4, 10, 6), (10, 6), torch.bool, ValueError),  # a 3D state
    ((9, 4, 10, 6), (4, 10, 6), torch.bool, ValueError),
    ((9, 2, 6), (2, 6), torch.bool, ValueError),       # no fluid row
])
def test_record_refuses_bad_mask_and_state(f_shape, mask_shape, mask_dtype,
                                           err):
    with pytest.raises(err):
        scrt_fused.record(torch.zeros(f_shape), torch.ones(mask_shape,
                                                           dtype=mask_dtype),
                          trt.SCRTParams())


# ─── physics on the port's plain path (tests/test_sc_variants.py) ──────────
def test_mass_conserved_and_walls_stay_zero():
    """100 steps of the 24 × 98 channel at the config physics, float64: mass
    conserved to rounding and the wall rows stay zero."""
    tp = trt.SCRTParams()
    fluid = trt.geometry_channel(NX, NY, device=CPU)
    f0 = trt.init_interface(NX, NY, tp, device=CPU) * fluid[None]
    f = trt.run(f0, fluid, tp, 100)
    assert bool(torch.isfinite(f).all())
    np.testing.assert_allclose(float(f.sum()), float(f0.sum()), rtol=1e-12)
    assert bool((f[:, 0] == 0).all()) and bool((f[:, -1] == 0).all())


def test_plain_path_matches_the_cpp_capture_at_250_steps():
    """The C++ capture gate of tests/test_sc_variants.py on the port's plain
    float64 path: the config at N = 128 (128 × 514, ω = 1), both probe
    columns within 5e-5 after 250 steps.  The later captured steps run
    through the kernel on the card (tests/test_torch_scrt_fused_gpu.py)."""
    jp = jrt.SCRTParams(omega=lb_parameters(0.04, 128, 30.72)[1], rhol=1.2,
                        rhog=0.4, g=-5.0, gravity=-1.25e-5)
    assert scrt_reference.config_params() == scrt_params_from_jax(
        dataclasses.asdict(jp))
    row = scrt_reference.compare(device=CPU, steps=(250,))[250]
    assert row["col0"] < scrt_reference.ATOL, row
    assert row["colmid"] < scrt_reference.ATOL, row
