"""The two-stage convergence-gated run of the PyTorch port's combustion model
against the JAX ``run_staged``, on the CPU: the obstacle-free 128 × 48
channel of tests/test_combustion.py:42-65 (with the obstacles the wake feeds
a slow outlet instability at this shape, faithful to the reference), float64,
checks every 500 steps to a 1e-4 kinetic-energy deviation.  Both packages
stop at the same step and their states agree to 1e-12; the port's state
passes the JAX test's physics checks (finite bulk, the parabolic inlet
profile's peak within 25% of u_inlet, inflow and outflow within 5%).
"""
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.models import combustion as jcb
from multiphase_lbm_tpu_torch.models import combustion as tcb

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)


def test_run_staged_matches_jax_and_converges():
    kw = dict(nx=128, ny=48, with_obstacles=False)
    jp, tp = jcb.CombustionParams(**kw), tcb.CombustionParams(**kw)
    jlog, tlog = [], []
    jst, jdone = jcb.run_staged(jcb.initialize(jp), jp, max_flow_steps=20000,
                                check_every=500, tol=1e-4,
                                log=lambda *a: jlog.append(a))
    tst, tdone = tcb.run_staged(tcb.initialize(tp, device=torch.device("cpu")),
                                tp, max_flow_steps=20000, check_every=500,
                                tol=1e-4, log=lambda *a: tlog.append(a))
    assert tdone == jdone < 20000
    assert [a[0] for a in tlog] == [a[0] for a in jlog]
    np.testing.assert_allclose([a[1] for a in tlog], [a[1] for a in jlog],
                               rtol=1e-10)
    for name, t, j in zip(tst._fields, tst, jst):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0.0,
                                   atol=1e-12, equal_nan=True, err_msg=name)
    flags, _ = tcb.build_geometry(tp)
    tab = tcb.build_static_tables(flags, tp)
    rho, u = tcb.macro_flow(tst.f)
    ux = u[0].numpy()
    assert np.isfinite(ux[tab["is_bulk"]]).all()
    assert ux[tp.ny // 2, 2] == pytest.approx(tp.u_inlet, rel=0.25)
    fin, fout = (float(v) for v in tcb.mass_flux_audit(tst, tab, tp))
    assert fin > 0 and abs(fout - fin) / fin < 0.05
    np.testing.assert_allclose(
        [fin, fout], [float(v) for v in jcb.mass_flux_audit(
            jst, jcb.build_static_tables(flags, jp), jp)], rtol=1e-10)
