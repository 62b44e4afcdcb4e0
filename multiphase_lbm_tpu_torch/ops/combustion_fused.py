"""Reactive MRT combustion step on the GPU: wrapper of
``csrc/combustion_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_combustion.py:
run_fused``.  On a CUDA tensor :func:`run_fused` launches the hand-written
kernel (three launches a step, the boundary launch only in the
inflow/outflow channel; see the source's header note) or raises; it never
substitutes the plain path for a failed build or launch.  On a CPU tensor,
and only there, it runs the plain PyTorch version (:func:`..models.combustion
.run`), which is what the CPU tests exercise.  The state keeps its dtype
(float32 or float64; the Pallas path is float32 only), and the caller's
tensors are never written.

:func:`check_params` refuses what the Pallas kernel's ``_check_supported``
refuses: the GUO2015 and HUBER2015 schemes, the TC corrector and free-slip
walls.  Its striped-kernel rule (x-periodic topologies need a 128-multiple
nx) was a lane-padding artefact of the TPU and does not apply.  The kernel
takes the geometry of :func:`..models.combustion.build_geometry`.

``first_step`` runs the first step of the call without the LI2014
conjugate fix, as :func:`..models.combustion.run` does; ``all_first_steps``
runs every step so, which is the shipped reference binary's behaviour (its
``first_step`` flag is never cleared, ``tests/test_combustion_parity.py``).

``LAUNCHES`` counts kernel steps launched by this process (one per step), so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models import combustion as cbm
from ..models.combustion import (M_INV, M_MAT, Q, W, CombustionParams,
                                 CombustionState)

LAUNCHES = 0

TOPOLOGIES = ("inflow_outflow", "cavity", "couette", "poiseuille")

_DOUBLES = ("t367", "t76", "wsum_bot", "wsum_top", "conj_neg_a", "conj_a",
            "conj_b2", "conj_c2", "half_dpdx", "half_dpdy", "dpdx", "dpdy",
            "D_O2", "D_CO2", "fac_O2", "fac_CO2", "fac_T", "A_pre", "neg_E",
            "R_id", "half_stoich", "M_CO2", "DM", "M_O2", "delta_hr",
            "cp_gas")
_INTS = ("io", "konv", "li2014", "body_force", "solid_reaction")


class _CombustionConst(ctypes.Structure):
    """Mirror of ``struct CombustionConst`` in ``csrc/combustion_step.cu``
    (same order)."""
    _fields_ = ([("w2", ctypes.c_double * 9)]
                + [(name, ctypes.c_double) for name in _DOUBLES[:4]]
                + [("amp_in", ctypes.c_double * 3)]
                + [(name, ctypes.c_double) for name in _DOUBLES[4:]]
                + [(name, ctypes.c_int) for name in _INTS])


def unsupported(p: CombustionParams):
    """What of ``p`` the kernel does not cover (the refusals of the Pallas
    ``_check_supported``); empty when it covers ``p``."""
    return [name for name, bad in (
        (f"topology {p.topology!r}", p.topology not in TOPOLOGIES),
        (f"scheme {p.scheme!r} (li2014 or none)",
         p.scheme not in ("li2014", "none")),
        ("the TC corrector (temperature_coupling)", p.temperature_coupling),
        ("free-slip walls (y_freeslip)", p.y_freeslip)) if bad]


def check_params(p: CombustionParams):
    """Raise ``NotImplementedError`` unless the kernel covers ``p``."""
    refused = unsupported(p)
    if refused:
        raise NotImplementedError(
            "the combustion kernel does not cover " + ", ".join(refused)
            + "; use models.combustion.run (the plain path)")


def supported(p: CombustionParams) -> bool:
    """True iff the kernel covers ``p``."""
    return not unsupported(p)


def kernel_constants(p: CombustionParams, konv: bool) -> _CombustionConst:
    """Host-side constants of one parameter set, in float64, each formed as
    the plain path forms it from Python floats."""
    c = _CombustionConst()
    c.w2[:] = [2.0 * float(W[k]) for k in range(Q)]
    sig = p.sigma
    a = (1.0 - sig) / (1.0 + sig)
    body = bool(p.dpdx or p.dpdy)
    values = dict(
        t367=float(W[3] + W[7] + W[6]), t76=float(W[7] + W[6]),
        wsum_bot=sum(float(W[k]) for k in (2, 3, 6, 5, 7)),
        wsum_top=sum(float(W[k]) for k in (3, 4, 6, 7, 8)),
        conj_neg_a=-a, conj_a=a, conj_b2=2.0 / (1.0 + sig),
        conj_c2=2.0 * sig / (1.0 + sig),
        half_dpdx=p.dpdx / 2.0, half_dpdy=p.dpdy / 2.0, dpdx=p.dpdx,
        dpdy=p.dpdy, D_O2=p.D_O2, D_CO2=p.D_CO2,
        fac_O2=(p.tau_O2 - 0.5) / p.tau_O2,
        fac_CO2=(p.tau_CO2 - 0.5) / p.tau_CO2,
        fac_T=(p.tau_T - 0.5) / p.tau_T, A_pre=p.A_pre, neg_E=-p.E_akt,
        R_id=p.R_id, half_stoich=0.5 * p.stoich_O2, M_CO2=p.M_CO2,
        DM=p.D_CO2 * p.M_O2, M_O2=p.M_O2, delta_hr=p.delta_hr,
        cp_gas=p.cp_gas)
    for name, v in values.items():
        setattr(c, name, float(v))
    c.amp_in[:] = [p.Y_O2_inlet, p.Y_CO2_inlet, p.T_inlet]
    c.io = int(p.topology == "inflow_outflow")
    c.konv = int(konv)
    c.li2014 = int(p.scheme == "li2014")
    c.body_force = int(body)
    c.solid_reaction = int(p.solid_reaction)
    return c


def kernel_matrices(p: CombustionParams) -> np.ndarray:
    """(6, 9, 9) float64: M⁻¹ diag(S) M of flow, O2, CO2, T and T solid, as
    the plain path's ``_mrt`` forms them, and M⁻¹ diag(1 − S/2) M of the
    body force."""
    S_all = p.S_vectors()
    mats = [M_INV @ np.diag(S) @ M_MAT for S in S_all]
    mats.append(M_INV @ np.diag(1.0 - 0.5 * S_all[0]) @ M_MAT)
    return np.stack(mats)


def kernel_tables(p: CombustionParams, device, dtype):
    """The kernel's static inputs for ``p``'s geometry: the flags and ck_n
    (int8), the momentum-exchange populations of column 0 and row ny − 1
    (``f_solid`` is zero elsewhere in every topology), and the matrices."""
    flags, f_solid = cbm.build_geometry(p)
    tab = cbm.build_static_tables(flags, p)
    fs_col = f_solid[:, :, 0].copy()
    fs_row = f_solid[:, -1, :].copy()
    fs_row[:, 0] = 0.0
    rest = f_solid.copy()
    rest[:, :, 0] = 0.0
    rest[:, -1, :] = 0.0
    assert not rest.any(), "f_solid outside column 0 and row ny - 1"
    ck = tab["ck_n"]
    assert np.array_equal(ck, np.rint(ck)) and np.abs(ck).max() <= 2
    as_t = dict(device=device)
    return dict(
        flags=torch.as_tensor(flags, dtype=torch.int8, **as_t),
        ckn=torch.as_tensor(ck.astype(np.int8), **as_t),
        fs_col=torch.as_tensor(fs_col, dtype=dtype, **as_t),
        fs_row=torch.as_tensor(fs_row, dtype=dtype, **as_t),
        mats=torch.as_tensor(kernel_matrices(p), dtype=dtype, **as_t))


def check_state(state, p: CombustionParams):
    """Raise unless ``state`` is a :class:`CombustionState` of contiguous
    tensors of one float dtype and one device with the shapes ``p`` gives."""
    if not isinstance(state, CombustionState):
        raise TypeError("state must be a CombustionState")
    ny, nx = p.ny, p.nx
    if ny < 5 or nx < 5:
        raise ValueError(f"the boundary phase needs ny >= 5 and nx >= 5, got "
                         f"{ny} x {nx}")
    if 8 * Q * ny * nx >= 2 ** 31:
        raise ValueError(f"{ny} x {nx} is too large for 32-bit indices")
    if not isinstance(state.f, torch.Tensor):
        raise TypeError("f must be a torch tensor")
    dtype, device = state.f.dtype, state.f.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"f must be float32 or float64, got {dtype}")
    for name in CombustionState._fields:
        t = getattr(state, name)
        shape = (ny, nx) if name == "q_heat" else (Q, ny, nx)
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, f on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _plain(state, p, n_steps, konv, first_step, all_first_steps):
    if all_first_steps:
        step, _ = cbm.make_step(p, konv=konv, first_step=True)
        for _ in range(n_steps):
            state = step(state)
        return state
    return cbm.run(state, p, n_steps, konv=konv, first_step=first_step)


_TABLES = {}


def run_fused(state: CombustionState, p: CombustionParams, n_steps: int,
              konv: bool = True, first_step: bool = False,
              all_first_steps: bool = False) -> CombustionState:
    """Advance ``n_steps`` steps (see the module docstring for
    ``first_step`` and ``all_first_steps``)."""
    global LAUNCHES
    check_params(p)
    check_state(state, p)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    device = state.f.device
    if device.type == "cpu":
        return _plain(state, p, n_steps, konv, first_step, all_first_steps)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")

    from . import _build

    lib = _build.load()
    dtype = state.f.dtype
    run = (lib.combustion_run_f32 if dtype == torch.float32
           else lib.combustion_run_f64)
    key = (p, str(device), dtype)
    if key not in _TABLES:
        _TABLES.clear()
        _TABLES[key] = kernel_tables(p, device, dtype)
    tb = _TABLES[key]
    consts = kernel_constants(p, konv)
    ny, nx = p.ny, p.nx
    a = torch.stack(list(state[:8]))
    b = torch.empty_like(a)
    fld = torch.empty((5, ny, nx), dtype=dtype, device=device)
    scratch = torch.empty(3 * (nx + ny), dtype=dtype, device=device)
    mode = 2 if all_first_steps else (1 if first_step else 0)
    # the library's runtime launches into the context current on this
    # thread: make it the tensor's device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = run(a.data_ptr(), b.data_ptr(), tb["flags"].data_ptr(),
                  tb["ckn"].data_ptr(), tb["fs_col"].data_ptr(),
                  tb["fs_row"].data_ptr(), tb["mats"].data_ptr(),
                  fld.data_ptr(), scratch.data_ptr(), ny, nx, n_steps, mode,
                  ctypes.addressof(consts), stream)
    if err != 0:
        raise RuntimeError("combustion_step launch failed: "
                           + lib.sc_error_string(err).decode())
    LAUNCHES += n_steps
    out = (b if n_steps % 2 else a).unbind(0)
    if konv:
        return CombustionState(*out, state.q_heat)
    return CombustionState(out[0], *state[1:])
