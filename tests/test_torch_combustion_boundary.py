"""What the CPU can reach of the combustion kernel's design
(``csrc/combustion_step.cu``), on the port's side of
``ops/combustion_fused.py``:

* the low-rank collision factors the wrapper hands the kernel rebuild the
  dense M⁻¹ diag(S) M of every population, and the body force's
  M⁻¹ diag(1 − S/2) M, to 1e-15;
* the plain version of the boundary launch (``boundary_plain``: each
  boundary cell's fixed values formed from the entry state alone, as one
  kernel thread forms them) against JAX's sequential ``apply_flow_outlet``
  and ``apply_scalar_bcs`` (with ``_species_outlet_corners``), float64 at
  1e-13, on channels of 5, 6 and 45 rows and 5 columns, where the bottom
  row's amplitude reads the fixed top row (ny = 5) and the corners' chains
  are longest;
* the same on slabs of the lattice that start at row0 ≠ 0 (the halo-in
  entry's slab mode), against the whole lattice's rows.

The inputs are drawn from a seeded numpy generator, positive so that every
density is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.models import combustion as jcb
from multiphase_lbm_tpu_torch.models import combustion as tcb
from multiphase_lbm_tpu_torch.ops import combustion_fused as cf

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

RATES = {"default": {},
         "mrt": dict(tau_flow=0.8, w_e=1.1, w_eps=1.2, w_q=1.3)}


def entry_state(nx, ny, seed=0):
    """f, g_O2, g_CO2, g_T of a (9, ny, nx) lattice, uniform in
    [0.01, 0.2), as numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.01, 0.2, (9, ny, nx)) for _ in range(4)]


def jax_phase1(state, nx, ny):
    """JAX's boundary phase of the inflow/outflow channel (make_step's
    phase 1 without the conjugate fix), as numpy arrays."""
    p = jcb.CombustionParams(nx=nx, ny=ny, Y_O2_ini=0.22)
    f, gO2, gCO2, gT = (jnp.asarray(a) for a in state)
    f_bc = jcb.apply_flow_outlet(f, p)
    return [np.asarray(a) for a in (
        f_bc,
        jcb.apply_scalar_bcs(gO2, p.Y_O2_inlet, p, species=True, f_bc=f_bc),
        jcb.apply_scalar_bcs(gCO2, p.Y_CO2_inlet, p, species=True,
                             f_bc=f_bc),
        jcb.apply_scalar_bcs(gT, p.T_inlet, p))]


@pytest.mark.parametrize("rates", sorted(RATES))
def test_low_rank_factors_rebuild_the_collisions(rates):
    p = tcb.CombustionParams(**RATES[rates])
    a, coef = cf.low_rank_factors(p)
    S_all = list(p.S_vectors()) + [1.0 - 0.5 * p.S_vectors()[0]]
    assert len(S_all) == len(cf.COLLISIONS) == len(a) == len(coef)
    for q, S in enumerate(S_all):
        dense = tcb.M_INV @ np.diag(S) @ tcb.M_MAT
        err = np.abs(cf.collision_matrix(a[q], coef[q]) - dense).max()
        assert err <= 1e-15, (cf.COLLISIONS[q], err)
    # work only for the rates other than the common one: g_T and the solid
    # are BGK, each species rank 2, the flow rank 0 at the default rates
    # and 6 at the full MRT
    ranks = dict(zip(cf.COLLISIONS, (coef != 0).sum(axis=1)))
    flow = 0 if rates == "default" else 6
    assert ranks == {"flow": flow, "O2": 2, "CO2": 2, "T": 0, "T_solid": 0,
                     "body_force": flow}


def test_low_rank_factors_of_equal_flow_rates_are_bgk_up_to_conservation():
    """1/τ_flow = w_e = w_eps = w_q = 1.25: the common rate is 1.25 and the
    factors are the three conserved moments (ρ, j_x, j_y) that S keeps at
    1."""
    p = tcb.CombustionParams(tau_flow=0.8, w_e=1.25, w_eps=1.25, w_q=1.25)
    a, coef = cf.low_rank_factors(p)
    assert a[0] == 1.25 and np.flatnonzero(coef[0]).tolist() == [0, 3, 5]
    np.testing.assert_allclose(
        cf.collision_matrix(a[0], coef[0]),
        tcb.M_INV @ np.diag(p.S_vectors()[0]) @ tcb.M_MAT, rtol=0, atol=1e-15)


@pytest.mark.parametrize("nx,ny", [(8, 5), (12, 6), (5, 5), (37, 45)])
def test_boundary_plain_matches_jax(nx, ny):
    state = entry_state(nx, ny)
    p = tcb.CombustionParams(nx=nx, ny=ny, Y_O2_ini=0.22)
    out = cf.boundary_plain([torch.as_tensor(a) for a in state], p)
    ref = jax_phase1(state, nx, ny)
    for name, o, r in zip(("f", "gO2", "gCO2", "gT"), out, ref):
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-13,
                                   err_msg=name)
    # the fixes change what they must: the entry state is not a fixed point
    assert all(not np.allclose(r, a) for r, a in zip(ref, state))


@pytest.mark.parametrize("row0,ny_ext", [
    (1, 43),    # both wall rows, at the slab's edges
    (40, 12),   # across the lattice's wrap: rows 40 .. 44, 0 .. 6
    (41, 9),    # wall rows 3 rows apart inside a short slab
    (10, 20),   # neither wall row: the column fixes alone
    (-4, 13),   # a negative row0 wraps, as the halo entry's first shard's
])
def test_boundary_plain_on_slabs(row0, ny_ext):
    """A slab whose wall rows read only rows it holds: its fixed values are
    the whole lattice's at its global rows (JAX's sequential phase)."""
    nx, ny = 37, 45
    state = entry_state(nx, ny, seed=1)
    p = tcb.CombustionParams(nx=nx, ny=ny, Y_O2_ini=0.22)
    rows = cf.slab_rows(p, row0, ny_ext)
    out = cf.boundary_plain([torch.as_tensor(a[:, rows]) for a in state], p,
                            row0)
    ref = jax_phase1(state, nx, ny)
    for name, o, r in zip(("f", "gO2", "gCO2", "gT"), out, ref):
        np.testing.assert_allclose(o.numpy(), r[:, rows], rtol=0, atol=1e-13,
                                   err_msg=name)
