"""The kernel-call seam of the port's wrappers (``ops/_build.py``,
``ops/_checks.py``) on the CPU: every row of ``_build.ENTRY_POINTS`` against
the signature of the C entry that ``csrc/*.cu`` defines, and every public
kernel entry's device rule (a device without a kernel raises, and so does
a negative step count).  The C call itself runs on the card only, in the
``gpu`` tests and ``chip_smoke.py``.
"""
import ctypes
import re

import pytest
import torch

from multiphase_lbm_tpu_torch.models import combustion as tcb
from multiphase_lbm_tpu_torch.models import pulsatile as tp
from multiphase_lbm_tpu_torch.models.fakhari import FakhariParams
from multiphase_lbm_tpu_torch.models.hcz import HCZParams
from multiphase_lbm_tpu_torch.models.shan_chen import SCParams
from multiphase_lbm_tpu_torch.models.shan_chen_rt import SCRTParams
from multiphase_lbm_tpu_torch.ops import (_build, combustion_fused,
                                          fakhari_fused, hcz3d_fused,
                                          hcz_fused, pulsatile_fused,
                                          sc_fused, scrt_fused)

torch.set_num_threads(1)

_SOURCES = {s.name: s.read_text() for s in _build.sources()}


def _signature(name):
    """The parameters of the C entry ``name``: ``[(type, name)]`` from the
    one source that defines it."""
    found = [m.group(1) for src in _SOURCES.values()
             for m in re.finditer(rf"\bint {name}\(([^)]*)\)", src)]
    assert len(found) == 1, (name, len(found))
    params = []
    for a in found[0].split(","):
        kind, _, arg = a.strip().rpartition(" ")
        params.append((kind + "*" * arg.count("*"), arg.lstrip("*")))
    return params


def _ctype(kind):
    if kind.endswith("*"):
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "double": ctypes.c_double}[kind]


@pytest.mark.parametrize("name", list(_build.ENTRY_POINTS))
def test_entry_point_row_follows_its_c_signature(name):
    """The row's argument types are the C entry's (pointers as c_void_p,
    ``int`` as c_int, ``double`` as c_double), and its last argument is
    the stream that ``_build.enqueue`` appends."""
    params = _signature(name)
    assert _build.ENTRY_POINTS[name] == [_ctype(k) for k, _ in params]
    assert params[-1] == ("void*", "stream")


def test_every_c_entry_has_a_row():
    """Each ``int <stem>_f32/_f64(`` the sources define outside their
    kernels has a row, so ``load`` declares its types."""
    defined = {m.group(1) for src in _SOURCES.values()
               for m in re.finditer(r"^int (\w+_f(?:32|64))\(", src, re.M)}
    assert defined == set(_build.ENTRY_POINTS)


# ─── the device rule of every public kernel entry ──────────────────────────
def _z(*shape, dev, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=dev)


_PB = tp.PulsatileParams(nx=61, ny=8)
_CB = tcb.CombustionParams(nx=20, ny=12, with_obstacles=False)


def _pulsatile_state(dev):
    ny, nx = _PB.ny, _PB.nx
    return tp.PulsatileState(
        g_coll=_z(9, ny, nx, dev=dev), g_stream=_z(9, ny, nx, dev=dev),
        yr1=_z(nx, dev=dev), yr2=_z(nx, dev=dev), P=_z(ny, nx, dev=dev),
        Ux=_z(ny, nx, dev=dev), Uy=_z(ny, nx, dev=dev),
        F=_z(ny + 2, nx + 2, dev=dev),
        fluid=_z(ny, nx, dev=dev, dtype=torch.bool))


def _combustion_state(dev):
    return tcb.CombustionState(*(_z(9, _CB.ny, _CB.nx, dev=dev)
                                 for _ in range(8)),
                               _z(_CB.ny, _CB.nx, dev=dev))


# entry -> call(device, steps); steps is n_steps, or nsub for a halo entry
ENTRIES = {
    "sc_fused.run_fused": lambda dev, n: sc_fused.run_fused(
        _z(9, 12, 8, dev=dev), _z(12, 8, dev=dev), SCParams(), n),
    "sc_fused.step_fused_halo": lambda dev, n: sc_fused.step_fused_halo(
        _z(9, 12, 8, dev=dev), _z(12, 8, dev=dev), SCParams(), n),
    "hcz_fused.run_fused": lambda dev, n: hcz_fused.run_fused(
        _z(9, 12, 8, dev=dev), _z(9, 12, 8, dev=dev), _z(12, 8, dev=dev),
        HCZParams(), n),
    "hcz_fused.step_fused_halo": lambda dev, n: hcz_fused.step_fused_halo(
        _z(9, 12, 8, dev=dev), _z(9, 12, 8, dev=dev), _z(12, 8, dev=dev),
        HCZParams(), n),
    "hcz_fused.record_2d": lambda dev, n: hcz_fused.record_2d(
        _z(9, 12, 8, dev=dev), _z(9, 12, 8, dev=dev), _z(12, 8, dev=dev),
        HCZParams()),
    "hcz3d_fused.run_fused_3d": lambda dev, n: hcz3d_fused.run_fused_3d(
        _z(19, 12, 4, 4, dev=dev), _z(19, 12, 4, 4, dev=dev), HCZParams(), n),
    "hcz3d_fused.step_fused_halo_3d":
        lambda dev, n: hcz3d_fused.step_fused_halo_3d(
            _z(19, 12, 4, 4, dev=dev), _z(19, 12, 4, 4, dev=dev),
            HCZParams(), n),
    "hcz3d_fused.record_3d": lambda dev, n: hcz3d_fused.record_3d(
        _z(19, 12, 4, 4, dev=dev), _z(19, 12, 4, 4, dev=dev), HCZParams()),
    "fakhari_fused.run_fused": lambda dev, n: fakhari_fused.run_fused(
        _z(9, 12, 8, dev=dev), _z(9, 12, 8, dev=dev), _z(2, 12, 8, dev=dev),
        FakhariParams(), n),
    "fakhari_fused.step_fused_halo":
        lambda dev, n: fakhari_fused.step_fused_halo(
            _z(9, 12, 8, dev=dev), _z(9, 12, 8, dev=dev),
            _z(2, 12, 8, dev=dev), FakhariParams(), n),
    "scrt_fused.run_fused": lambda dev, n: scrt_fused.run_fused(
        _z(9, 12, 8, dev=dev), SCRTParams(), n),
    "scrt_fused.step_fused_halo": lambda dev, n: scrt_fused.step_fused_halo(
        _z(9, 12, 8, dev=dev), SCRTParams(), n),
    "scrt_fused.record": lambda dev, n: scrt_fused.record(
        _z(9, 12, 8, dev=dev), _z(12, 8, dev=dev, dtype=torch.bool),
        SCRTParams()),
    "pulsatile_fused.run_fused_full":
        lambda dev, n: pulsatile_fused.run_fused_full(
            _pulsatile_state(dev), 0, _PB, n),
    "pulsatile_fused.fresh_map": lambda dev, n: pulsatile_fused.fresh_map(
        _z(2, _PB.nx, dev=dev), _z(2, _PB.nx, dev=dev), _PB),
    "combustion_fused.run_fused": lambda dev, n: combustion_fused.run_fused(
        _combustion_state(dev), _CB, n),
    "combustion_fused.step_fused_halo":
        lambda dev, n: combustion_fused.step_fused_halo(
            tuple(_combustion_state(dev)[:8]), None, -4, _CB, nsub=n),
}
# the entries without a step count
NO_STEPS = {"hcz_fused.record_2d", "hcz3d_fused.record_3d",
            "scrt_fused.record", "pulsatile_fused.fresh_map"}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_refuses_a_device_without_a_kernel(entry):
    """A ``meta`` tensor (neither CUDA nor CPU) raises ``ValueError``; a
    step count of -1 raises ``ValueError`` on the CPU, before any step."""
    call = ENTRIES[entry]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call("meta", 1)
    if entry not in NO_STEPS:
        with pytest.raises(ValueError, match="must be >= [01], got -1"):
            call("cpu", -1)
