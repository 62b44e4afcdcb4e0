"""The Shan–Chen layered channel of the PyTorch port against the JAX
package, on the CPU: ``validation/layered_poiseuille`` and the layered
constant-G flow of ``tests/test_sc_variants.py``.

The gate's own size (64², 40,000 float64 steps through the kernel) runs on
the card (``chip_smoke.py``); here a short run of the plain path is held to
JAX's at float64 atol 1e-12.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from multiphase_lbm_tpu.validation import layered_poiseuille as jlp
from multiphase_lbm_tpu_torch.io.config import lb_parameters
from multiphase_lbm_tpu_torch.models import shan_chen as sc
from multiphase_lbm_tpu_torch.validation import layered_poiseuille as tlp

# see tests/test_torch_hcz.py: six xdist workers' thread pools spin
# against each other without this
torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_analytic_profile_matches_jax():
    """The layers' density profile at 32² (x-averaged, walls at zero) and a
    random one through both integrators: the same profile."""
    p = sc.SCParams(TT0=0.95, rhol=0.21, rhog=0.067)
    fluid = sc.geometry_channel_walls(32, 32, device=CPU)
    f = sc.apply_geometry(sc.init_layers(32, 32, p, device=CPU), fluid)
    layers = sc.density(f).numpy().mean(axis=1)
    noisy = 0.067 + 0.14 * np.random.default_rng(0).random(32)
    for rho_y in (layers, noisy):
        for nu, fx in ((1.0 / 6.0, 1e-6), (0.1, -3e-7)):
            np.testing.assert_array_equal(
                tlp.analytic_profile(rho_y, nu, fx),
                jlp.analytic_profile(rho_y, nu, fx))


def test_short_run_matches_jax():
    """``run(n=32, steps=200)`` on the CPU gives JAX's profile, analytic
    profile and deviation at float64 atol 1e-12."""
    prof, ana, err = tlp.run(n=32, steps=200, device="cpu")
    jprof, jana, jerr = jlp.run(n=32, steps=200, dtype=jnp.float64)
    np.testing.assert_allclose(prof, np.asarray(jprof), rtol=0.0, atol=1e-12)
    np.testing.assert_allclose(ana, np.asarray(jana), rtol=0.0, atol=1e-12)
    assert abs(err - float(jerr)) <= 1e-12 * max(1.0, abs(float(jerr)))


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(tlp.torch.cuda, "is_available", lambda: False)
    assert tlp.main(["10"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_layered_flow_const_g():
    """tests/test_sc_variants.py:25 on the port's plain path: the gx drive
    accelerates the flow, mass holds to 1e-12 and the layering persists
    (liquid in the middle, gas near the walls) over 600 steps at 50²."""
    nu, omega, dx, dt = lb_parameters(0.1, 50, 60.0)
    p0 = sc.SCParams(TT0=0.95, rhol=0.21, rhog=0.067, rho_w=0.067,
                     psi_mode="const_g", G=-1.0, omega=omega, gx_u=1e-7)
    p = dataclasses.replace(p0, p_shift=sc.compute_p_shift(p0))
    nx, ny = 50, 50
    f = sc.init_layers(nx, ny, p, h_lower=0.3, w_int=4, device=CPU)
    fluid = sc.geometry_channel_walls(nx, ny, device=CPU)
    f = sc.apply_geometry(f, fluid)
    m0 = float(sc.total_mass(f, fluid))
    f = sc.run(f, fluid, p, 600)
    assert abs(float(sc.total_mass(f, fluid)) - m0) / m0 < 1e-12
    rho = sc.density(f).numpy()
    assert np.isfinite(rho).all()
    assert rho[ny // 2, 10] > rho[3, 10]
    u = sc.u_actual(f, fluid, p).numpy()
    assert u[0][fluid.numpy()].mean() > 0.0
