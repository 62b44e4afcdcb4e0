"""The combustion step of the PyTorch port against the JAX ``make_step``,
20 steps at float64 in every branch, on the CPU, at the default relaxation
rates.  tests/test_torch_combustion_step_mrt.py runs the same branches at
τ_flow = 0.8, w_e = 1.1, w_eps = 1.2, w_q = 1.3.

At the default τ_flow = 1 and w_e = w_eps = w_q = 1 the flow relaxation
diagonal is all ones, so the flow MRT is BGK; at the second set of rates
every flow moment relaxes at its own rate.  Every case starts from the same
warm state on both sides, made on the port's plain path from
``initialize(T_solid=1.8)`` with ``Y_O2_ini = 0.22`` (one first step and
three more), so the Arrhenius term, the anti-bounce-back with Y_int and the
heat release are live from the first compared step.  Tolerance: atol
1e-12, with NaN in the same places (the forcing terms and u are NaN at
solid cells in both packages).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.models import combustion as jcb
from multiphase_lbm_tpu_torch.models import combustion as tcb
from multiphase_lbm_tpu_torch.utils.convert import combustion_params_from_jax

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

CPU = torch.device("cpu")
STEPS = 20
LIVE = dict(Y_O2_ini=0.22)
CHANNEL = dict(nx=137, ny=45, **LIVE)
SMALL = dict(nx=48, ny=24, **LIVE)
# branch -> (params, make_step keywords)
BRANCHES = {
    "li2014": (CHANNEL, {}),
    "li2014-first-step": (CHANNEL, dict(first_step=True)),
    "konv-off": (CHANNEL, dict(konv=False)),
    "none": (dict(CHANNEL, conj_scheme="none"), {}),
    "no-solid-reaction": (dict(CHANNEL, solid_reaction=False), {}),
    "guo2015": (dict(CHANNEL, conj_scheme="guo2015"), {}),
    "huber2015": (dict(CHANNEL, conj_scheme="huber2015"), {}),
    "tc-corrector": (dict(CHANNEL, temperature_coupling=True), {}),
    "free-slip": (dict(CHANNEL, y_freeslip=True), {}),
    "cavity": (dict(SMALL, topology="cavity", u_lid=0.05), {}),
    "couette": (dict(SMALL, topology="couette", u_lid=0.04), {}),
    "poiseuille": (dict(SMALL, topology="poiseuille", dpdx=1e-6), {}),
}
DEFAULT_RATES = {}
FULL_MRT = dict(tau_flow=0.8, w_e=1.1, w_eps=1.2, w_q=1.3)


def run_branch(branch, rates):
    """20 steps of ``branch`` on both sides from the shared warm state;
    asserts every field within 1e-12 with NaN in the same places and
    returns the port's state."""
    kw, step_kw = BRANCHES[branch]
    jp = jcb.CombustionParams(**{**kw, **rates})
    tp = combustion_params_from_jax(dataclasses.asdict(jp))
    flags, _ = tcb.build_geometry(tp)
    st = tcb.initialize(tp, T_solid=1.8, flags=flags, device=CPU)
    st = tcb.run(st, tp, 4, first_step=True)
    jst = jcb.CombustionState(*(jnp.asarray(t.numpy()) for t in st))
    jstep, _ = jcb.make_step(jp, **step_kw)
    tstep, _ = tcb.make_step(tp, **step_kw)
    jstep = jax.jit(jstep)
    for _ in range(STEPS):
        jst = jstep(jst)
        st = tstep(st)
    for name, t, j in zip(st._fields, st, jst):
        t, j = t.numpy(), np.asarray(j)
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j),
                                      err_msg=name)
        np.testing.assert_allclose(t, j, rtol=0.0, atol=1e-12,
                                   equal_nan=True, err_msg=name)
    return st


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_step_matches_jax_at_default_rates(branch):
    st = run_branch(branch, DEFAULT_RATES)
    kw, step_kw = BRANCHES[branch]
    if ("topology" not in kw and kw.get("solid_reaction", True)
            and step_kw.get("konv", True)):
        # the reaction is live at the obstacles: CO2 appears in the gas.
        # Free-slip walls have no species rule in the model, so the rows
        # next to them pull NaN from the wall cells (JAX and port alike).
        bulk = torch.as_tensor(tcb.build_geometry(
            tcb.CombustionParams(**kw))[0] == tcb.BULK)
        Y = tcb.macro_scalar(st.gCO2)[bulk]
        assert float(Y[torch.isfinite(Y)].max()) > 1e-3
