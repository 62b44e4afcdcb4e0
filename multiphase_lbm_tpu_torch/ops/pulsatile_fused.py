"""Whole-step pulsatile-vessel kernel on the GPU: wrapper of
``csrc/pulsatile_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_pulsatile_full.py:
run_fused_full``: one reference iteration per step (collide, the two
Bouzidi wall passes, pull stream, Zou/He, macros with the k = 0 quirk, wall
ODE, geometry rebuild, reseed) in the reference parity mode only.  On a CUDA
tensor :func:`run_fused_full` launches the hand-written kernel (eight
launches a step; see the source's header note) or raises; it never
substitutes the plain path for a failed build or launch.  On a CPU tensor,
and only there, it runs the plain PyTorch version
(:func:`..models.pulsatile.run_with_diag`), which is what the CPU tests
exercise.  The state keeps its dtype (the Pallas path is float32 only), and
the kernel reads the walls (``yr1``, ``yr2``), the populations and the
macros; ``F`` and ``fluid`` of the result are rebuilt from the walls, as
the Pallas ``unpack_state`` does.  A float32 state straight from
:func:`..models.pulsatile.initialize` carries an ``F`` formed in float64,
so its first step can differ from the plain path where F ≈ 1; after one
step the two agree.

``LAUNCHES`` counts kernel steps launched by this process (one per step), so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..models import pulsatile as pm
from ..models.pulsatile import PulsatileParams, PulsatileState

LAUNCHES = 0

_DOUBLES = ("rho0", "rho0_3", "rho0_2_9", "rho0_18", "neg_rho0_18", "yc",
            "alpha", "p_tissue", "ytop", "pin", "pout", "p_osc", "omega")
_INTS = ("nrel", "y0", "t_start", "t_prop", "severed", "t_sever")


class _PulsatileConst(ctypes.Structure):
    """Mirror of ``struct PulsatileConst`` in ``csrc/pulsatile_step.cu``
    (same order)."""
    _fields_ = ([("Mr", ctypes.c_double * 81), ("C", ctypes.c_double * 81)]
                + [(name, ctypes.c_double) for name in _DOUBLES]
                + [(name, ctypes.c_int) for name in _INTS])


def kernel_constants(p: PulsatileParams) -> _PulsatileConst:
    """Host-side constants of one parameter set, in float64 (the kernel
    rounds them to its working type, as JAX rounds Python floats)."""
    c = _PulsatileConst()
    Mr, C = pm.mrt_low_rank(p)
    c.nrel = len(Mr)
    c.Mr[:len(Mr) * 9] = [float(v) for v in Mr.reshape(-1)]
    c.C[:len(C) * 9] = [float(v) for v in C.reshape(-1)]
    for name, value in (
            ("rho0", p.rho0), ("rho0_3", p.rho0 / 3.0),
            ("rho0_2_9", 2.0 * p.rho0 / 9.0), ("rho0_18", p.rho0 / 18.0),
            ("neg_rho0_18", -p.rho0 / 18.0), ("yc", p.yc),
            ("alpha", p.alpha), ("p_tissue", p.p_tissue),
            ("ytop", p.ny - 1 - 0.5), ("pin", p.pin), ("pout", p.pout),
            ("p_osc", p.p_osc), ("omega", p.omega), ("y0", p.y0),
            ("t_start", p.t_start), ("t_prop", p.t_propagation),
            ("severed", int(p.is_severed)), ("t_sever", p.t_sever)):
        setattr(c, name, value)
    return c


def check_params(p: PulsatileParams):
    """Raise unless ``p`` is the reference parity mode that the kernel
    implements (the Pallas kernel checks only the first flag)."""
    refused = [name for name, ok in (
        ("momentum_quirk", p.momentum_quirk),
        ("pingpong", p.pingpong),
        ("mrt_basis_scrambled", p.mrt_basis_scrambled),
        ("no corner_closure", not p.corner_closure),
        ("collision == 'mrt'", p.collision == "mrt"),
        ("deformable", p.deformable)) if not ok]
    if refused:
        raise NotImplementedError(
            "the pulsatile kernel implements the reference parity mode "
            f"only; these do not hold: {', '.join(refused)} (use "
            "models.pulsatile.run for the other modes)")


def check_state(state, p: PulsatileParams):
    """Raise unless ``state`` is a :class:`PulsatileState` of contiguous
    tensors of one float dtype and one device with the shapes ``p`` gives
    (``fluid`` bool)."""
    if not isinstance(state, PulsatileState):
        raise TypeError("state must be a PulsatileState")
    ny, nx = p.ny, p.nx
    if ny < 4 or nx < 2:
        raise ValueError(f"the vessel needs ny >= 4 and nx >= 2, got "
                         f"{ny} x {nx}")
    if 9 * ny * nx >= 2 ** 31:
        raise ValueError(f"{ny} x {nx} is too large for 32-bit indices")
    shapes = {"g_coll": (9, ny, nx), "g_stream": (9, ny, nx), "yr1": (nx,),
              "yr2": (nx,), "P": (ny, nx), "Ux": (ny, nx), "Uy": (ny, nx),
              "F": (ny + 2, nx + 2), "fluid": (ny, nx)}
    if not isinstance(state.g_coll, torch.Tensor):
        raise TypeError("g_coll must be a torch tensor")
    dtype = state.g_coll.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"g_coll must be float32 or float64, got {dtype}")
    device = state.g_coll.device
    for name, shape in shapes.items():
        t = getattr(state, name)
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        want = torch.bool if name == "fluid" else dtype
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, g_coll on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def run_fused_full(state: PulsatileState, t0, p: PulsatileParams,
                   n_steps: int):
    """Advance ``n_steps`` steps from step index ``t0``.  Returns
    ``(state, diag)``: ``diag`` is a CPU int64 tensor, ``diag[0]`` the
    order-dependent reseed steps (filled densely instead of sequentially)
    and ``diag[1]`` the reseeded cells.  The caller's tensors are never
    written."""
    global LAUNCHES
    check_params(p)
    check_state(state, p)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    device = state.g_coll.device
    if device.type == "cpu":
        st, (n_dep, n_cells) = pm.run_with_diag(state, t0, p, n_steps)
        return st, torch.tensor([n_dep, n_cells], dtype=torch.int64)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")

    from . import _build

    lib = _build.load()
    dtype = state.g_coll.dtype
    step = (lib.pulsatile_step_f32 if dtype == torch.float32
            else lib.pulsatile_step_f64)
    consts = kernel_constants(p)
    ny, nx = p.ny, p.nx
    src = (state.g_coll, state.g_stream,
           torch.stack([state.P, state.Ux, state.Uy]),
           torch.stack([state.yr1, state.yr2]))
    bufs = [tuple(torch.empty_like(t) for t in src) for _ in range(2)]
    cap = 4 * nx + 256          # fresh cells a step can hold (≤ 2 per column)
    ints = dict(dtype=torch.int32, device=device)
    bz_idx = torch.empty(6 * nx, **ints)
    bz_val = torch.empty(6 * nx, dtype=dtype, device=device)
    rs_idx = torch.empty(cap, **ints)
    rs_val = torch.empty(9 * cap, dtype=dtype, device=device)
    ctr = torch.zeros(8, **ints)
    # the library's runtime launches into the context current on this
    # thread: make it the tensor's device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for i in range(n_steps):
            dst = bufs[i % 2]
            err = step(*(t.data_ptr() for t in src),
                       *(t.data_ptr() for t in dst),
                       bz_idx.data_ptr(), bz_val.data_ptr(),
                       rs_idx.data_ptr(), rs_val.data_ptr(), ctr.data_ptr(),
                       ny, nx, cap, int(t0) + i, i % 2,
                       ctypes.addressof(consts), stream)
            if err != 0:
                raise RuntimeError("pulsatile_step launch failed: "
                                   + lib.sc_error_string(err).decode())
            LAUNCHES += 1
            src = dst
    counts = ctr[:3].cpu().to(torch.int64)
    if counts[2]:
        raise RuntimeError(f"{int(counts[2])} steps had more than {cap} "
                           "fresh cells, the kernel's list")
    gc, gs, mac, yr = src
    if n_steps == 0:
        gc, gs = gc.clone(), gs.clone()
    F = pm.fobj_from_walls(yr[0], yr[1], p)
    return (PulsatileState(g_coll=gc, g_stream=gs, yr1=yr[0], yr2=yr[1],
                           P=mac[0], Ux=mac[1], Uy=mac[2], F=F,
                           fluid=pm.flags_from_fobj(F, p)),
            counts[:2])
