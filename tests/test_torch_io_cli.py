"""I/O, driver and CLI of the PyTorch port against the JAX package, on the
CPU.

The port's ``coolbm`` and the JAX ``coolbm`` run the same shrunken config
at float64; they must write the same files, with the same VTK headers and
field lists, and fields equal to 1e-6 relative (the VTK text keeps 6
significant digits; atol 1e-12 covers values that are zero up to rounding).
"""
import os
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiphase_lbm_tpu.io import config as jconfig
from multiphase_lbm_tpu.io import vtk as jvtk
from multiphase_lbm_tpu.models import hcz as jhcz
from multiphase_lbm_tpu.models import shan_chen_rt as jrt
from multiphase_lbm_tpu.runners import coolbm as jcoolbm
from multiphase_lbm_tpu_torch.io import checkpoint as tckpt
from multiphase_lbm_tpu_torch.io import config as tconfig
from multiphase_lbm_tpu_torch.io import vtk as tvtk
from multiphase_lbm_tpu_torch.io.loggers import DatLogger, MlupsClock
from multiphase_lbm_tpu_torch.runners import coolbm as tcoolbm
from multiphase_lbm_tpu_torch.runners.common import Driver, next_chunk

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


def _shrunk_config(src, dst, **overrides):
    lines = []
    for line in open(src):
        key = line.split()[0] if line.strip() and not line.startswith("#") else None
        if key in overrides:
            line = f"{key}    {overrides.pop(key)}\n"
        lines.append(line)
    lines += [f"{k}    {v}\n" for k, v in overrides.items()]
    Path(dst).write_text("".join(lines))


def _vtk_header(path):
    return Path(path).read_text().split("POINT_DATA")[0]


def _vtk_field_list(path):
    return [line.split()[:2] for line in Path(path).read_text().splitlines()
            if line.startswith(("SCALARS", "VECTORS"))]


CLI_CASES = {
    "laplace2D_sc": ("sc_Laplace2D.txt",
                     dict(N=40, out_freq=20, vtk_freq=20), 40),
    "contactAngle2D": ("sc_contactAngle2D.txt",
                       dict(N=20, RR=8, tau=0.8, out_freq=10, vtk_freq=10), 20),
    # the constant-G layered channel at N = 20 (ω ≈ 1.67) with a drive of
    # 1e-6 (the config's 1e-8 leaves the dumped velocities at rounding)
    "twoLayeredFlow2D_sc": ("sc_twoLayeredFlow2D.txt",
                            dict(N=20, gx=1e-6, gy=-2e-7, out_freq=10,
                                 vtk_freq=20), 40),
    # the HCZ problems at N = 16 with Re lowered so that ω ≈ 1.5
    "rayleighTaylor2D": ("pf_rayleighTaylor2D.txt",
                         dict(N=16, Re=11.52, out_freq=10, vtk_freq=20), 40),
    "twoLayeredFlow2D": ("pf_twoLayeredFlow2D.txt",
                         dict(N=16, Re=28.8, out_freq=10, vtk_freq=20), 40),
    "laplace3D": ("pf_laplace3D.txt",
                  dict(N=16, Re=2.88, out_freq=10, vtk_freq=10), 20),
    # the Fakhari bubble at N = 32 (its loop runs to it == steps inclusive)
    "Young_Laplace2D": ("young_laplace2D.txt",
                        dict(N=32, out_freq=10, vtk_freq=30), 40),
    # SC-RT at N = 16 (16 × 66) with Re lowered so that ω = 1.25
    "RayleighTaylor2D_sc": ("sc_RayleighTaylor2D.txt",
                            dict(N=16, Re=6.4, out_freq=10, vtk_freq=20), 40),
}


@pytest.mark.parametrize("problem", sorted(CLI_CASES))
def test_cli_matches_jax_cli(problem, tmp_path):
    name, overrides, steps = CLI_CASES[problem]
    cfg = tmp_path / "config.txt"
    _shrunk_config(CONFIG_DIR / name, cfg, **overrides)
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    assert jcoolbm.main([problem, "--config", str(cfg), "--outdir", str(jout),
                         "--steps", str(steps)]) == 0
    assert tcoolbm.main([problem, "--config", str(cfg), "--outdir", str(tout),
                         "--steps", str(steps), "--device", "cpu"]) == 0
    names = sorted(os.listdir(jout))
    assert sorted(os.listdir(tout)) == names
    assert sum(n.startswith("sol_") for n in names) == 2
    for n in names:
        if n.endswith(".vtk"):
            assert _vtk_header(tout / n) == _vtk_header(jout / n)
            assert _vtk_field_list(tout / n) == _vtk_field_list(jout / n)
            tf, jf = tvtk.read_vtk_fields(tout / n), jvtk.read_vtk_fields(jout / n)
            assert tf.keys() == jf.keys()
            for key in jf:
                np.testing.assert_allclose(tf[key], jf[key], rtol=1e-6,
                                           atol=1e-12, err_msg=f"{n}:{key}")
        elif (problem, n) == ("RayleighTaylor2D_sc", "spike_bubble_position.dat"):
            _sc_rows_follow_the_capture_rule(tout / n, jout / n, cfg)
        else:
            np.testing.assert_allclose(np.loadtxt(tout / n), np.loadtxt(jout / n),
                                       rtol=1e-9, err_msg=n)


def _sc_rows_follow_the_capture_rule(tfile, jfile, cfg):
    """The port's SC-RT spike and bubble rows follow the rule of the C++
    capture's rows (the topmost light row of x = nx/2 and of x = 0), which
    the JAX package's SC record does not: the times equal the JAX file's,
    and the rows of every record equal the JAX package's PF
    findInterfaceHeights on the JAX package's density at that record,
    stepped by its own SC-RT model from its own initial state."""
    got, jax_lines = np.loadtxt(tfile), np.loadtxt(jfile)
    np.testing.assert_allclose(got[:, 0], jax_lines[:, 0], rtol=1e-12)
    keys = jconfig.load_config(str(cfg))
    N, out_freq = int(keys["N"]), int(keys["out_freq"])
    _, omega, dx, _ = jconfig.lb_parameters(float(keys["ulb"]), N, float(keys["Re"]))
    p = jrt.SCRTParams(omega=omega, rhol=float(keys["rhol"]), rhog=float(keys["rhog"]),
                       g=float(keys["g"]), gravity=float(keys["gravity"]))
    nx, ny = N, 4 * N + 2
    fluid = jrt.geometry_channel(nx, ny)
    f = jrt.init_interface(nx, ny, p, dtype=jnp.float64) * fluid[None]
    cut = SimpleNamespace(phi_l=p.rhol, phi_g=p.rhog)
    for k, line in enumerate(got):
        if k:
            f = jrt.run(f, fluid, p, out_freq)
        rows = np.asarray(jhcz.interface_heights(np.asarray(jrt.density(f)), cut)) * dx
        np.testing.assert_allclose(line[1:], rows, rtol=1e-12, err_msg=f"record {k}")
    assert len(got) == 4        # the records at 0, 10, 20 and 30 of 40 steps


@pytest.mark.parametrize("mode", [[], ["--quirk-free"]])
def test_pulsatile_cli_matches_jax_cli(mode, tmp_path):
    """PulsatileBloodFlow2D takes no config file: N = 16 (141 × 16), 30
    steps, tf // 100 = 0, so one dump a step: 31 VTK files, in the parity
    mode and the quirk-free mode."""
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    argv = ["PulsatileBloodFlow2D", "--N", "16", "--steps", "30", *mode]
    assert jcoolbm.main([*argv, "--outdir", str(jout)]) == 0
    assert tcoolbm.main([*argv, "--outdir", str(tout), "--device", "cpu"]) == 0
    names = sorted(os.listdir(jout))
    assert sorted(os.listdir(tout)) == names
    assert len(names) == 31 and all(n.startswith("sol_") for n in names)
    for n in names:
        assert _vtk_header(tout / n) == _vtk_header(jout / n)
        assert _vtk_field_list(tout / n) == _vtk_field_list(jout / n)
        tf, jf = tvtk.read_vtk_fields(tout / n), jvtk.read_vtk_fields(jout / n)
        assert tf.keys() == jf.keys()
        for key in jf:
            np.testing.assert_allclose(tf[key], jf[key], rtol=1e-6,
                                       atol=1e-12, err_msg=f"{n}:{key}")


def test_cli_offers_every_problem_of_the_jax_cli(monkeypatch, capsys):
    """Every problem of the JAX CLI (its PROBLEMS and the two without a
    config file) passes the port's argument parser and reaches the device
    check, which refuses without a card; an unknown name does not parse."""
    monkeypatch.setattr(tcoolbm.torch.cuda, "is_available", lambda: False)
    assert set(tcoolbm.PROBLEMS) == set(jcoolbm.PROBLEMS)
    for problem in [*jcoolbm.PROBLEMS, "PulsatileBloodFlow2D", "combustion"]:
        assert tcoolbm.main([problem]) == 2
        assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tcoolbm.main(["noSuchProblem"])


def _combustion_argv(topology, extra, outdir):
    return ["combustion", "--topology", topology, "--nx", "48", "--ny", "16",
            "--steps", "30", "--scalar-steps", "5", "--outdir", str(outdir),
            *extra]


def _same_outputs(tout, jout):
    """The port's run wrote the JAX run's files, with the same VTK headers
    and field lists, fields equal to the VTK text's 6 digits and .dat
    columns to 1e-6 relative (the two packages sum in other orders)."""
    names = sorted(os.listdir(jout))
    assert sorted(os.listdir(tout)) == names
    for n in names:
        if n.endswith(".vtk"):
            assert _vtk_header(tout / n) == _vtk_header(jout / n)
            assert _vtk_field_list(tout / n) == _vtk_field_list(jout / n)
            tf, jf = tvtk.read_vtk_fields(tout / n), jvtk.read_vtk_fields(jout / n)
            assert tf.keys() == jf.keys()
            for key in jf:
                np.testing.assert_allclose(tf[key], jf[key], rtol=1e-6,
                                           atol=1e-12, err_msg=f"{n}:{key}")
        elif n.endswith("_names.dat"):
            assert (tout / n).read_text() == (jout / n).read_text()
        elif n == "ini_f.dat":
            np.testing.assert_allclose(tckpt.load_flow_field_txt(tout / n),
                                       tckpt.load_flow_field_txt(jout / n),
                                       rtol=1e-9, err_msg=n)
        else:
            np.testing.assert_allclose(np.loadtxt(tout / n),
                                       np.loadtxt(jout / n), rtol=1e-6,
                                       atol=1e-15, err_msg=n)


@pytest.mark.parametrize("topology,extra", [
    ("cavity", ["--u-lid", "0.01"]),
    ("couette", ["--u-lid", "0.01"]),
    ("poiseuille", ["--dpdx", "1e-6"]),
])
def test_combustion_cli_topology_smoke(topology, extra, tmp_path):
    """Each reference domain branch from the CLI at 48 × 16
    (tests/test_combustion.py:317-335): the run completes, stays finite and
    writes the audit and VTK set; the cavity's files equal the JAX CLI's."""
    tout = tmp_path / "torch"
    assert tcoolbm.main(_combustion_argv(topology, extra, tout)
                        + ["--device", "cpu"]) == 0
    vtk = list(tout.glob("sol_*.vtk"))
    assert vtk and "velocity_Z" in vtk[0].read_text()
    fields = tvtk.read_vtk_fields(vtk[0])
    bulk = fields["Flag"] == 0        # u is 0/0 at the walls, by design
    for key, field in fields.items():
        if key != "DIMENSIONS":
            assert np.isfinite(field[bulk]).all(), key
    if topology == "cavity":
        jout = tmp_path / "jax"
        assert jcoolbm.main(_combustion_argv(topology, extra, jout)) == 0
        _same_outputs(tout, jout)


def test_combustion_cli_restart_workflow(tmp_path):
    """The two-stage round trip at 96 × 48 (tests/test_combustion.py:338-358):
    the flow stage writes ini_f.dat, and a --restart run reads it and goes
    straight to the reactive stage."""
    out1, out2 = tmp_path / "stage1", tmp_path / "stage2"
    base = ["combustion", "--nx", "96", "--ny", "48", "--device", "cpu"]
    assert tcoolbm.main([*base, "--steps", "600", "--scalar-steps", "40",
                         "--outdir", str(out1)]) == 0
    assert (out1 / "ini_f.dat").exists()
    assert tcoolbm.main([*base, "--scalar-steps", "40", "--restart",
                         str(out1 / "ini_f.dat"), "--outdir", str(out2)]) == 0
    assert not (out2 / "ini_f.dat").exists()
    assert (out2 / "inlet_massflow.dat").exists()
    assert list(out2.glob("velocity_middleline_*.dat"))
    vtk = list(out2.glob("sol_*.vtk"))
    assert vtk and "velocity_Z" in vtk[0].read_text()
    assert np.isfinite(np.loadtxt(out2 / "conservation.dat")).all()
    with pytest.raises(ValueError, match="does not match"):
        tcoolbm.main(["combustion", "--nx", "64", "--ny", "48", "--device",
                      "cpu", "--restart", str(out1 / "ini_f.dat"),
                      "--outdir", str(tmp_path / "bad")])


def test_combustion_cli_bench_runs_the_plain_path_and_says_why(tmp_path,
                                                               capsys):
    """--bench with the guo2015 scheme, which no kernel covers: the plain
    path runs, and a line says so and why."""
    assert tcoolbm.main(["combustion", "--nx", "64", "--ny", "32", "--bench",
                         "--scheme", "guo2015", "--device", "cpu",
                         "--outdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "does not cover scheme 'guo2015'" in out
    assert "plain PyTorch path" in out and "MLUPS" in out


def test_combustion_cli_refuses_without_a_card(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(tcoolbm.torch.cuda, "is_available", lambda: False)
    assert tcoolbm.main(["combustion", "--outdir", str(tmp_path)]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_cli_refuses_without_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                             capsys, tmp_path):
    """The device defaults to cuda; with no visible card the CLI exits
    non-zero and names --device cpu instead of running on the CPU."""
    monkeypatch.setattr(tcoolbm.torch.cuda, "is_available", lambda: False)
    assert tcoolbm.main(["rayleighTaylor2D", "--outdir", str(tmp_path)]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("name", sorted(p.name for p in CONFIG_DIR.glob("*.txt")))
def test_config_parse_matches_jax(name):
    text = (CONFIG_DIR / name).read_text()
    assert tconfig.parse_config_text(text) == jconfig.parse_config_text(text)


def test_lb_parameters_match_jax():
    assert tconfig.lb_parameters(0.01, 100, 6.0) == jconfig.lb_parameters(0.01, 100, 6.0)
    assert tconfig.omega_from_tau(0.8) == jconfig.omega_from_tau(0.8)


def _fields(ny=6, nx=8):
    rng = np.random.default_rng(7)
    rho = rng.uniform(0.0, 2.0, (ny, nx))
    u = rng.standard_normal((2, ny, nx)) * 1e-3
    flag = (rho > 1.0).astype(np.int32)
    return rho, u, flag


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_vtk_writer_bytes_equal_jax(dtype, tmp_path):
    rho, u, flag = _fields()
    ny, nx = rho.shape
    out = {}
    for tag, mod in (("jax", jvtk), ("torch", tvtk)):
        w = mod.VtkWriter(nx, ny, spacing=0.01, iteration=27)
        w.scalar("Density", rho.astype(dtype)).vector("Force", u.astype(dtype))
        w.vector("Velocity3", np.concatenate([u, u[:1]]).astype(dtype))
        w.scalar("Flag", flag, as_int=True)
        path = tmp_path / f"{tag}_{mod.sol_filename(27)}"
        w.write(path)
        out[tag] = path.read_bytes()
    assert out["torch"] == out["jax"]


def test_driver_async_vtk_matches_sync_bytes(tmp_path):
    """Async dumps must produce byte-identical files to the synchronous
    path, be fully on disk after finish(), and surface worker errors
    there."""
    rho, u, flag = _fields(12, 16)
    ny, nx = rho.shape
    fields = dict(scalars=[("Density", torch.as_tensor(rho, dtype=torch.float32))],
                  vectors=[("velocity", torch.as_tensor(u))],
                  int_scalars=[("Flag", torch.as_tensor(flag))])
    d_sync = Driver(tmp_path / "sync", nx * ny, vtk_freq=1, async_io=False)
    d_async = Driver(tmp_path / "async", nx * ny, vtk_freq=1)
    for it in (0, 27, 54, 81):          # > the in-flight bound of 2
        d_sync.write_vtk(it, nx, ny, **fields)
        d_async.write_vtk(it, nx, ny, **fields)
    d_sync.finish()
    d_async.finish()
    for it in (0, 27, 54, 81):
        a = (tmp_path / "async" / tvtk.sol_filename(it)).read_bytes()
        s = (tmp_path / "sync" / tvtk.sol_filename(it)).read_bytes()
        assert a == s

    d_bad = Driver(tmp_path / "bad", nx * ny, vtk_freq=1)
    d_bad.outdir = tmp_path / "bad" / "missing-subdir"   # unwritable target
    d_bad.write_vtk(0, nx, ny, **fields)
    with pytest.raises(OSError):
        d_bad.finish()


def test_next_chunk_and_loggers(tmp_path):
    assert next_chunk(0, 11, 3, 5) == 3
    assert next_chunk(3, 11, 3, 5) == 2
    assert next_chunk(10, 11, 3, 5) == 1
    with DatLogger(tmp_path / "x.dat") as log:
        log.log(100, 2.5e-8)
    assert (tmp_path / "x.dat").read_text() == "100 2.5e-08\n"
    clock = MlupsClock(nelem=1000)
    clock.tick(10)
    assert clock.mlups > 0 and "MLUPS" in clock.report()
