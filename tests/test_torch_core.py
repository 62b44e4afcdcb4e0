"""Core modules of the PyTorch port against the JAX package, on the CPU.

Copied tables must equal the JAX arrays exactly; the closed forms,
equilibria, collisions and streaming must agree on random float64 fields
and masks (numpy, fixed seed) to atol 1e-13 — the only differences are
summation order in the contractions.  Also: the port imports no jax, the
JAX→port converters, and the slope timing's guards.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.core import collision as jcol
from multiphase_lbm_tpu.core import eos as jeos
from multiphase_lbm_tpu.core import lattice as jlat
from multiphase_lbm_tpu.core import streaming as jstr
from multiphase_lbm_tpu.models import shan_chen as jsc
from multiphase_lbm_tpu_torch.core import collision as tcol
from multiphase_lbm_tpu_torch.core import eos as teos
from multiphase_lbm_tpu_torch.core import lattice as tlat
from multiphase_lbm_tpu_torch.core import streaming as tstr
from multiphase_lbm_tpu_torch.utils import convert, profiling

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

ATOL = 1e-13
NY, NX = 12, 20


def _rng():
    return np.random.default_rng(1234)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0.0, atol=atol)


TABLES = ["D2Q9.c", "D2Q9.w", "D2Q9.opp", "D3Q19.c", "D3Q19.w", "D3Q19.opp",
          "D2Q9_REST_FIRST.c", "D2Q9_REST_FIRST.w", "D2Q9_REST_FIRST.opp",
          "EX_I", "EY_I", "JB_I", "K_FROM_I"]
MATRICES = ["MRT_M_I", "MRT_M_I_INV", "MRT_M_K", "MRT_M_K_INV"]


def _get(mod, path):
    obj = mod
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("name", TABLES)
def test_lattice_tables_equal_jax(name):
    t, j = _get(tlat, name), _get(jlat, name)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("name", MATRICES)
def test_mrt_matrices_equal_jax(name):
    np.testing.assert_array_equal(getattr(tcol, name), getattr(jcol, name))


def test_lattice_roll_shifts_equal_jax():
    for name in ("D2Q9", "D3Q19", "D2Q9_REST_FIRST"):
        assert getattr(tlat, name).roll_shifts() == getattr(jlat, name).roll_shifts()


# ─── eos ───────────────────────────────────────────────────────────────────
A, B, R = 1.0, 4.0, 1.0
T = 0.875 * jeos.yuan_Tc(A, B, R)
EOS_CASES = {
    "carnahan_starling_pressure": lambda m, r: m.carnahan_starling_pressure(r, 0.5, 4.0),
    "cs_psi": lambda m, r: m.cs_psi(r, 0.5, 4.0),
    "yuan_Z": lambda m, r: m.yuan_Z(r),
    "yuan_pressure": lambda m, r: m.yuan_pressure(r, A, R, T),
    "yuan_G1": lambda m, r: m.yuan_G1(r, A, R, T),
    "yuan_psi": lambda m, r: m.yuan_psi(r, A, R, T),
    "yuan_psi_shifted": lambda m, r: m.yuan_psi(r, A, R, T, 0.003),
    "yuan_psi_fixed_branch": lambda m, r: m.yuan_psi_fixed_branch(
        0.2 * r / r, A, R, T, m.yuan_G1(r, A, R, T), 0.001),
    "yuan_node_pressure": lambda m, r: m.yuan_node_pressure(r, A, R, T, 0.002),
    "psi_exponential": lambda m, r: m.psi_exponential(r),
    "double_well_mu": lambda m, r: m.double_well_mu(r, 0.3, 0.02, r * r - 0.1),
}


@pytest.mark.parametrize("name", sorted(EOS_CASES))
def test_eos_matches_jax(name):
    rho = _rng().uniform(0.02, 0.35, (NY, NX))     # spans both G1 branches
    fn = EOS_CASES[name]
    _close(fn(teos, torch.as_tensor(rho)), fn(jeos, jnp.asarray(rho)))


def test_eos_scalars_match_jax():
    assert teos.CS2 == jeos.CS2
    assert teos.yuan_Tc(A, B, R) == jeos.yuan_Tc(A, B, R)


# ─── collision ─────────────────────────────────────────────────────────────
def _fields(q=9):
    rng = _rng()
    f = rng.uniform(0.001, 0.1, (q, NY, NX))
    rho = f.sum(0)
    u = rng.uniform(-0.05, 0.05, (2, NY, NX))
    return f, rho, u


def test_equilibrium_matches_jax():
    _, rho, u = _fields()
    _close(tcol.equilibrium(torch.as_tensor(rho), torch.as_tensor(u), tlat.D2Q9),
           jcol.equilibrium(jnp.asarray(rho), jnp.asarray(u), jlat.D2Q9))


@pytest.mark.parametrize("omega", [1.0, 1.25, 0.7])
def test_bgk_collide_matches_jax(omega):
    f, rho, u = _fields()
    feq = np.array(jcol.equilibrium(jnp.asarray(rho), jnp.asarray(u), jlat.D2Q9))
    _close(tcol.bgk_collide(torch.as_tensor(f), torch.as_tensor(feq), omega),
           jcol.bgk_collide(jnp.asarray(f), jnp.asarray(feq), omega))


@pytest.mark.parametrize("basis", ["I", "K"])
@pytest.mark.parametrize("omega", [1.0, 1.25])
def test_mrt_collide_matches_jax(basis, omega):
    f, rho, u = _fields()
    feq = np.array(jcol.equilibrium(jnp.asarray(rho), jnp.asarray(u), jlat.D2Q9))
    S = np.array([1.0, 1.1, 1.2, 1.0, 1.3, 1.0, 1.3, omega, omega])
    tM = (tcol.MRT_M_I, tcol.MRT_M_I_INV) if basis == "I" else (tcol.MRT_M_K, tcol.MRT_M_K_INV)
    jM = (jcol.MRT_M_I, jcol.MRT_M_I_INV) if basis == "I" else (jcol.MRT_M_K, jcol.MRT_M_K_INV)
    _close(tcol.mrt_collide(torch.as_tensor(f), torch.as_tensor(feq), S, *tM),
           jcol.mrt_collide(jnp.asarray(f), jnp.asarray(feq), S, *jM))


# ─── streaming ─────────────────────────────────────────────────────────────
@pytest.mark.parametrize("lat", ["D2Q9", "D3Q19"])
def test_stream_periodic_matches_jax(lat):
    tl, jl = getattr(tlat, lat), getattr(jlat, lat)
    shape = (tl.q, NY, NX) if tl.d == 2 else (tl.q, 5, 6, 7)
    post = _rng().standard_normal(shape)
    _close(tstr.stream_periodic(torch.as_tensor(post), tl),
           jstr.stream_periodic(jnp.asarray(post), jl), atol=0.0)


@pytest.mark.parametrize("lat", ["D2Q9", "D3Q19"])
def test_stream_bounce_back_matches_jax(lat):
    tl, jl = getattr(tlat, lat), getattr(jlat, lat)
    rng = _rng()
    shape = (tl.q, NY, NX) if tl.d == 2 else (tl.q, 5, 6, 7)
    post = rng.standard_normal(shape)
    fluid = rng.uniform(size=shape[1:]) > 0.3
    _close(tstr.stream_bounce_back(torch.as_tensor(post), torch.as_tensor(fluid), tl),
           jstr.stream_bounce_back(jnp.asarray(post), jnp.asarray(fluid), jl),
           atol=0.0)


# ─── package boundary ──────────────────────────────────────────────────────
def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import importlib, pkgutil\n"
        "import multiphase_lbm_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_params_and_state_from_jax():
    jp = jsc.SCParams(omega=1.25, collision="mrt", rho_w=0.2, gravity=1e-5,
                      wall_psi_center_branch=False)
    tp = convert.params_from_jax(dataclasses.asdict(jp))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tp.T == jp.T and tp.tau == jp.tau
    f = jsc.init_droplet(NX, NY, jp, radius=4.0, dtype=jnp.float32)
    fluid = jsc.geometry_channel_walls(NX, NY)
    tf, tfluid = convert.state_from_numpy(np.asarray(f), np.asarray(fluid),
                                          "cpu", torch.float32)
    assert tf.dtype == torch.float32 and tfluid.dtype == torch.bool
    np.testing.assert_array_equal(tf.numpy(), np.asarray(f))
    np.testing.assert_array_equal(tfluid.numpy(), np.asarray(fluid))
    with pytest.raises(TypeError):
        convert.params_from_jax({**dataclasses.asdict(jp), "nsub": 2})


# ─── timing guards ─────────────────────────────────────────────────────────
@pytest.mark.parametrize("n1,n2", [(5, 5), (6, 5), (0, 5)])
def test_measure_mlups_slope_rejects_bad_step_counts(n1, n2):
    with pytest.raises(ValueError):
        profiling.measure_mlups_slope(lambda n: (lambda s: s), torch.zeros(2),
                                      n1, n2, nelem=4)


def test_measure_mlups_slope_invalid_reading_has_no_rate(monkeypatch):
    """A longer run that reads no slower (noise) yields per-step <= 0: the
    reading is marked invalid and carries no MLUPS."""
    clock = iter([0.0, 1.0, 1.0, 2.0, 2.0, 2.5])     # t(n1) = 1.0, t(n2) = 0.5
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    rd = profiling.measure_mlups_slope(lambda n: (lambda s: s), torch.zeros(2),
                                       2, 4, nelem=4, reps=1)
    assert not rd.valid and rd.mlups is None and rd.ms_per_step is None


def test_measure_mlups_counts_steps():
    rd = profiling.measure_mlups(lambda s: s + 1, torch.zeros(4), 10, 100, reps=2)
    assert rd.valid and rd.mlups > 0 and rd.ms_per_step > 0
    assert torch.equal(rd.out, torch.ones(4))


def test_device_profile_on_the_cpu_has_no_device_time():
    """The profiler helper's bookkeeping: on CPU tensors no kernel runs on
    a device, so it reports no device time and an idle share of 1."""
    prof = profiling.device_profile(lambda s: s * 2.0 + 1.0, torch.ones(64), 4)
    assert prof["steps"] == 4 and prof["wall_ms_per_step"] > 0
    assert prof["kernels"] == [] and prof["device_busy_ms_per_step"] == 0
    assert prof["idle_share"] == 1.0
