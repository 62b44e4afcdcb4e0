"""The decomposed combustion channel of the PyTorch port against the JAX
package, on the CPU: ``ops/combustion_fused.step_fused_halo`` (the halo-in
entry of the combustion kernel, whose plain version runs here),
``parallel/sharding.make_fused_combustion_step`` and the ``combustion``
cases of ``validation/multichip_check.py``.

Warm reacting states come from the port's plain path (held to JAX in every
branch by tests/test_torch_combustion_step*.py) with seeded numpy noise,
and go to both packages as numpy arrays.  Tolerances:

* the halo-in entry against JAX's in interpret mode on the same extended
  slab (shard 0 of 4, whose halo wraps to the top wall rows), float32 rtol
  2e-4, atol 5e-6 (those of tests/test_pallas_combustion.py), over the cells
  where the model defines each field (``defined_values``);
* the decomposed path on 4 CPU shards against as many steps of JAX's global
  XLA step, float64 atol 1e-12 with NaN in the same places (summation order
  differs);
* the narrow case (4 shards of 5 rows, exchange 4 rows) against the port's
  own single-lattice run: identical.

The kernel on the card is held to these plain paths by
tests/test_torch_sharding_gpu.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.models import combustion as jcb
from multiphase_lbm_tpu.ops import pallas_combustion
from multiphase_lbm_tpu_torch.models import combustion as tcb
from multiphase_lbm_tpu_torch.ops import combustion_fused as cf
from multiphase_lbm_tpu_torch.parallel import sharding as sh
from multiphase_lbm_tpu_torch.utils.convert import combustion_params_from_jax
from multiphase_lbm_tpu_torch.validation import multichip_check

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _params(**kw):
    """(JAX params, port params) with the same fields."""
    jp = jcb.CombustionParams(**kw)
    return jp, combustion_params_from_jax(dataclasses.asdict(jp))


def _warm_noisy(tp, seed, scale=1e-3):
    """The first eight fields of multichip_check's warm reacting state of
    ``tp`` (float64), each scaled by 1 + ``scale``·N(0, 1) cell by cell, and
    q_heat, as numpy arrays."""
    st = multichip_check.combustion_warm_state(tp, CPU, torch.float64)
    rng = np.random.default_rng(seed)
    noisy = [t.numpy() * (1.0 + scale * rng.standard_normal(t.shape))
             for t in st[:8]]
    return noisy + [st.q_heat.numpy()]


def _defined(arrays, flags):
    """The tensors of ``defined_values`` of the eight state arrays."""
    st = tcb.CombustionState(*(torch.as_tensor(np.array(a)) for a in arrays),
                             None)
    return list(tcb.defined_values(st, flags).values())


def test_halo_entry_matches_pallas_interpret():
    """Two sub-steps of the port's halo-in entry (the plain path, on the
    CPU) against JAX's ``step_fused_halo`` in interpret mode on shard 0 of 4
    of the warm 128 × 64 channel (own rows 0..15, halo 8), float32."""
    jp, tp = _params(nx=128, ny=64, Y_O2_ini=0.22)
    arrays = _warm_noisy(tp, 21)
    row0, ny_ext = -8, 32
    rows = np.arange(row0, row0 + ny_ext) % tp.ny
    ext = [np.ascontiguousarray(a[:, rows], np.float32) for a in arrays[:8]]
    flags, f_solid = jcb.build_geometry(jp)
    m9, m2 = pallas_combustion.build_mask_inputs(jp, flags=flags,
                                                 f_solid=f_solid)
    ref = pallas_combustion.step_fused_halo(
        tuple(jnp.asarray(a) for a in ext),
        jnp.asarray(np.asarray(m9)[:, :, rows]),
        jnp.asarray(np.asarray(m2)[:, rows]), row0, jp, konv=True, nsub=2,
        tile=16, halo=8, interpret=True)
    before = cf.HALO_LAUNCHES
    out = cf.step_fused_halo(
        tuple(torch.as_tensor(a) for a in ext),
        cf.slab_tables(tp, row0, ny_ext, CPU, torch.float32), row0, tp,
        konv=True, nsub=2, halo=8)
    assert cf.HALO_LAUNCHES == before      # the plain path launches nothing
    assert all(o.shape == (9, 16, 128) and o.dtype == torch.float32
               for o in out)
    own = flags[:16]
    for o, r in zip(_defined(out, own), _defined(ref, own)):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=2e-4,
                                   atol=5e-6)


@pytest.mark.parametrize("topology,konv", [("inflow_outflow", True),
                                           ("inflow_outflow", False),
                                           ("cavity", True)])
def test_decomposed_path_matches_jax_global_step(topology, konv):
    """Two calls of make_fused_combustion_step (4 y shards of 16 rows, nsub
    2, exchange 8 rows) against JAX's global XLA run of 4 steps, float64,
    NaN in the same places: the channel with all four populations and flow
    only, and the lid cavity, whose lid row (the momentum exchange of the
    global top row) lies on the last shard only."""
    kw = dict(topology="cavity", u_lid=0.05) if topology == "cavity" else {}
    jp, tp = _params(nx=128, ny=64, Y_O2_ini=0.22, **kw)
    arrays = _warm_noisy(tp, 22)
    ref = jcb.run(jcb.CombustionState(*(jnp.asarray(a) for a in arrays)), jp,
                  4, konv=konv)
    mesh = sh.make_mesh(4, axis_names=("y",), devices=[CPU] * 4)
    step = sh.make_fused_combustion_step(mesh, tp, konv=konv, nsub=2)
    out = tuple(sh.shard_lattice(torch.as_tensor(a), mesh)
                for a in arrays[:8])
    before = cf.HALO_LAUNCHES
    for _ in range(2):
        out = step(*out)
    assert cf.HALO_LAUNCHES == before
    assert len(out) == 8
    for o, r in zip(out, ref[:8]):
        assert o.shape == (9, 64, 128)
        np.testing.assert_allclose(o.gather().numpy(), np.asarray(r),
                                   rtol=0.0, atol=1e-12)


def test_narrow_decomposition_is_identical_to_single_lattice():
    """The 128 × 20 channel on 4 shards of 5 rows at nsub 1 (exchange 4
    rows): the cuts at rows 5, 10 and 15 fall within 4 rows of the wall rows
    1 and 18 and through the obstacle rows 7..12; 4 steps equal the port's
    single-lattice run in every cell, NaN positions included."""
    res = multichip_check.check("combustion_narrow", "cpu",
                                dtype=torch.float64)
    assert res["mesh"] == (4,) and res["nsub"] == 1 and res["steps"] == 4
    assert res["ok"] and res["max_abs_err"] == 0.0 and res["bit_identical"]


@pytest.mark.parametrize("what", ["narrow halo", "slab taller than ny",
                                  "device without a kernel", "mesh axes",
                                  "another slab's tables"])
def test_refusals(what):
    _, tp = _params(nx=32, ny=20)
    slab = tuple(torch.zeros(9, 12, 32) for _ in range(8))
    if what == "narrow halo":
        with pytest.raises(ValueError, match="reach"):
            cf.step_fused_halo(slab, None, -2, tp, nsub=1, halo=3)
        with pytest.raises(ValueError, match="reach"):
            cf.step_halo_plain(slab, -4, tp, nsub=2, halo=4)
    elif what == "slab taller than ny":
        tall = tuple(torch.zeros(9, 21, 32) for _ in range(8))
        with pytest.raises(ValueError, match="does not fit"):
            cf.step_fused_halo(tall, None, -4, tp, nsub=1)
        with pytest.raises(ValueError, match="does not fit"):
            cf.slab_tables(tp, 0, 21, CPU, torch.float32)
    elif what == "device without a kernel":
        meta = tuple(t.to("meta") for t in slab)
        with pytest.raises(ValueError, match="no kernel"):
            cf.step_fused_halo(meta, None, -4, tp, nsub=1)
    elif what == "another slab's tables":
        # same shape, built for shard 1's rows: flags, ck_n and fs_col of
        # other rows would give a wrong step
        tables = cf.slab_tables(tp, 1, 12, CPU, torch.float32)
        with pytest.raises(ValueError, match="built for global row 1"):
            cf.step_fused_halo(slab, tables, -4, tp, nsub=1)
        cf.step_fused_halo(slab, cf.slab_tables(tp, -4, 12, CPU,
                                                torch.float32), 16, tp)
    else:
        mesh = sh.make_mesh(4, axis_names=("x",), devices=[CPU] * 4)
        with pytest.raises(ValueError, match="axes"):
            sh.make_fused_combustion_step(mesh, tp)


def test_halo_bound_work_counts_the_rows_kept_valid():
    """The halo route's bound for combustion: at nsub 1 each shard keeps
    its own rows only, so the operations are those of the whole lattice and
    the bytes those of the four shards' own rows; at nsub 2 the first
    sub-step also keeps 4 rows on each side of every shard."""
    case, _ = multichip_check.make_case("combustion_narrow", "cpu")
    p = tcb.CombustionParams(nx=128, ny=20, Y_O2_ini=0.22)
    nbytes, ops = multichip_check.halo_bound_work(case)
    assert ops == 128 * 20 * 1500
    assert nbytes == sum(cf.step_work(p, True, np.arange(5 * i, 5 * i + 5))[0]
                         for i in range(4))
    case2 = dataclasses.replace(case, nsub=2)
    _, ops2 = multichip_check.halo_bound_work(case2)
    assert ops2 == (4 * (5 + 8) + 4 * 5) * 128 * 1500 / 2
    assert cf.step_work(p, True) == cf.step_work(p, True, np.arange(20))
