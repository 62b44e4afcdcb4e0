"""The combustion CUDA kernel of the port (``csrc/combustion_step.cu``)
against the plain PyTorch path, and against the capture of the C++
reference, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device: the kernel has no CPU mode.  This file imports no jax, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu -s tests/test_torch_combustion_fused_gpu.py

Cases (from a warm state with Y_O2_ini = 0.22 and T_solid = 1.8, so the
reaction is live): (a) the inflow/outflow channel at 137 × 45, li2014, at
the default τ, where the flow relaxation diagonal is all ones; (b) the same
at τ_flow = 0.8, w_e = 1.1, w_eps = 1.2, w_q = 1.3, so the full flow MRT is
live; (c) (b) with first_step; (d) flow only; (e) scheme none without the
solid reaction; (f) the cavity with all four populations, Couette and
Poiseuille (body force, τ_flow = 0.8) flow only; and a 133 × 43 channel,
whose cell count is no multiple of the block.  The boundary launch's
reordered dependencies: the channel at ny = 5 (8 × 5, where the bottom
row's amplitude reads the fixed top row), at ny = 6 (12 × 6) and at nx = 5
(5 × 5); the collision factors: τ_O2 ≠ τ_CO2, τ_T ≠ τ_T_solid and the full
flow MRT together, so that every factor is distinct ("distinct"), and the
flow's four rates equal at 1.25 (1/τ_flow = w_e = w_eps = w_q), BGK at
ω ≠ 1 but for the conserved moments, in the channel and with the body
force ("bgk", "bgk-poiseuille").  Tolerances: float32 over 5
steps rtol 2e-5, atol 2e-6, tighter than tests/test_pallas_combustion.py's
2e-4 / 5e-6 (the largest error chip_smoke.py measured on an H100 was
5.4e-7); float64 over 20 steps atol 1e-12.  f, g_O2 and g_CO2 are compared
over the bulk and obstacle cells, g_T and g_coll over every cell, the three
forcing terms over the bulk cells (the plain path holds NaN at solid cells,
as the JAX model does, and no step reads them there).
"""
import dataclasses

import numpy as np
import pytest
import torch

from multiphase_lbm_tpu_torch import bench
from multiphase_lbm_tpu_torch.models import combustion as cbm
from multiphase_lbm_tpu_torch.ops import combustion_fused as cf
from multiphase_lbm_tpu_torch.validation import combustion_reference

pytestmark = pytest.mark.gpu

STEPS = {torch.float32: 5, torch.float64: 20}
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-6),
       torch.float64: dict(rtol=0.0, atol=1e-12)}
MRT = dict(tau_flow=0.8, w_e=1.1, w_eps=1.2, w_q=1.3)
LIVE = dict(Y_O2_ini=0.22)
DISTINCT = dict(tau_O2=0.9, tau_CO2=1.1, tau_T=0.7, tau_T_solid=1.4)
BGK = dict(tau_flow=0.8, w_e=1.25, w_eps=1.25, w_q=1.25)
CASES = {
    "a": (dict(nx=137, ny=45, **LIVE), {}),
    "b": (dict(nx=137, ny=45, **LIVE, **MRT), {}),
    "c": (dict(nx=137, ny=45, **LIVE, **MRT), dict(first_step=True)),
    "d": (dict(nx=137, ny=45, **LIVE, **MRT), dict(konv=False)),
    "e": (dict(nx=137, ny=45, conj_scheme="none", solid_reaction=False,
               **LIVE), {}),
    "f-cavity": (dict(nx=64, ny=32, topology="cavity", u_lid=0.05, **LIVE,
                      **MRT), {}),
    "f-couette": (dict(nx=64, ny=32, topology="couette", u_lid=0.04, **MRT),
                  dict(konv=False)),
    "f-poiseuille": (dict(nx=64, ny=32, topology="poiseuille", dpdx=1e-6,
                          tau_flow=0.8), dict(konv=False)),
    "odd": (dict(nx=133, ny=43, **LIVE, **MRT), {}),
    "ny5": (dict(nx=8, ny=5, **LIVE, **MRT), {}),
    "ny6": (dict(nx=12, ny=6, **LIVE, **MRT), {}),
    "nx5": (dict(nx=5, ny=5, **LIVE, **MRT), {}),
    "distinct": (dict(nx=137, ny=45, **LIVE, **MRT, **DISTINCT), {}),
    "bgk": (dict(nx=137, ny=45, **LIVE, **BGK), {}),
    "bgk-poiseuille": (dict(nx=64, ny=32, topology="poiseuille", dpdx=1e-6,
                            **BGK), dict(konv=False)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def warm(p, dtype, device, steps=10):
    flags, _ = cbm.build_geometry(p)
    st = cbm.initialize(p, dtype, T_solid=1.8, flags=flags, device=device)
    return cf.run_fused(st, p, steps, first_step=True)


def max_errors(out, ref, p):
    """Each field of the kernel's and the plain path's state over the cells
    where the model defines it (``cbm.defined_values``), and whether every
    one is finite there."""
    flags, _ = cbm.build_geometry(p)
    a, r = cbm.defined_values(out, flags), cbm.defined_values(ref, flags)
    errs = {name: (a[name].double().cpu(), r[name].double().cpu())
            for name in a}
    finite = all(bool(torch.isfinite(x).all() & torch.isfinite(y).all())
                 for x, y in errs.values())
    return errs, finite


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda_device, case, dtype):
    kw, run_kw = CASES[case]
    p = cbm.CombustionParams(**kw)
    st = warm(p, dtype, cuda_device)
    n = STEPS[dtype]
    before = cf.LAUNCHES
    out = cf.run_fused(st, p, n, **run_kw)
    torch.cuda.synchronize()
    assert cf.LAUNCHES == before + n
    ref = cbm.run(st, p, n, **run_kw)
    assert out.f.dtype == dtype
    errs, finite = max_errors(out, ref, p)
    assert finite
    for name, (a, r) in errs.items():
        np.testing.assert_allclose(a.numpy(), r.numpy(), **TOL[dtype],
                                   err_msg=name)


def test_reference_lattice_one_step_float32(cuda_device):
    p = bench.combustion_params(420)
    st = bench.combustion_state(p, cuda_device)
    out = cf.run_fused(st, p, 1)
    ref = cbm.run(st, p, 1)
    errs, finite = max_errors(out, ref, p)
    assert finite
    for name, (a, r) in errs.items():
        np.testing.assert_allclose(a.numpy(), r.numpy(),
                                   **TOL[torch.float32], err_msg=name)


def test_kernel_leaves_input_untouched(cuda_device):
    p = cbm.CombustionParams(nx=137, ny=45, **LIVE)
    st = warm(p, torch.float32, cuda_device)
    before = [t.clone() for t in st]
    for n in (0, 1, 2, 3):
        out = cf.run_fused(st, p, n)
        assert out.f.data_ptr() != st.f.data_ptr()
        cf.run_fused(st, p, n, konv=False)
    torch.cuda.synchronize()
    # equal_nan: the forcing terms hold NaN at solid cells, by design
    assert all(torch.allclose(a, b, rtol=0.0, atol=0.0, equal_nan=True)
               for a, b in zip(st, before))


def test_kernel_rejects_unsupported_state(cuda_device):
    p = cbm.CombustionParams(nx=64, ny=32, **LIVE)
    st = cbm.initialize(p, torch.float32, device=cuda_device)
    with pytest.raises(TypeError):                   # half precision
        cf.run_fused(cbm.CombustionState(*(t.half() for t in st)), p, 1)
    with pytest.raises(TypeError):                   # mixed dtypes
        cf.run_fused(st._replace(gT=st.gT.double()), p, 1)
    with pytest.raises(ValueError):                  # one field on the CPU
        cf.run_fused(st._replace(gO2=st.gO2.cpu()), p, 1)
    with pytest.raises(ValueError):                  # shape
        cf.run_fused(st._replace(f=st.f[:, :, :-1].contiguous()), p, 1)
    with pytest.raises(ValueError):                  # non-contiguous
        cf.run_fused(st._replace(gCO2=st.gCO2.transpose(1, 2)
                                 .contiguous().transpose(1, 2)), p, 1)
    for bad in (dict(conj_scheme="guo2015"), dict(conj_scheme="huber2015"),
                dict(temperature_coupling=True), dict(y_freeslip=True)):
        with pytest.raises(NotImplementedError):
            cf.run_fused(st, dataclasses.replace(p, **bad), 1)


def test_kernel_matches_the_cpp_capture(cuda_device):
    """The 128 × 48 capture in float64 through the kernel, every field of
    FIELDS within its tolerance at steps 100-500; the float32 run is
    printed."""
    rows = combustion_reference.compare(device=cuda_device)
    for step, row in rows.items():
        print(f"[capture] float64 step {step}: {row}")
    assert combustion_reference.within(rows), rows
    rows32 = combustion_reference.compare(device=cuda_device,
                                          dtype=torch.float32)
    for step, row in rows32.items():
        print(f"[capture] float32 step {step}: {row}")
