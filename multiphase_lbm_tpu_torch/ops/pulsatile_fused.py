"""Whole-step pulsatile-vessel kernel on the GPU: wrapper of
``csrc/pulsatile_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_pulsatile_full.py:
run_fused_full``: one reference iteration per step (collide, the two
Bouzidi wall passes, pull stream, Zou/He, macros with the k = 0 quirk, wall
ODE, geometry rebuild, reseed) in the reference parity mode only.  On a CUDA
tensor :func:`run_fused_full` launches the hand-written kernel (five
launches a step, :data:`LAUNCHES_PER_STEP`, all of a call's steps from one
ctypes call; see the source's header note) or raises; it never substitutes
the plain path for a failed build or launch.  On a CPU tensor, and only
there, it runs the plain PyTorch version
(:func:`..models.pulsatile.run_with_diag`), which is what the CPU tests
exercise.  The state keeps its dtype (the Pallas path is float32 only), and
the kernel reads the walls (``yr1``, ``yr2``), the populations and the
macros; ``F`` and ``fluid`` of the result are rebuilt from the walls, as
the Pallas ``unpack_state`` does.  A float32 state straight from
:func:`..models.pulsatile.initialize` carries an ``F`` formed in float64,
so its first step can differ from the plain path where F ≈ 1; after one
step the two agree.

Each call counts its steps and launches in the recorder of
:mod:`..utils.profiling` (``kernel.steps.pulsatile_step``,
``kernel.launches.pulsatile_step``), so a run can show that its main path
went through the kernel, and records the ``kernel.prepare`` and
``kernel.enqueue`` spans, and the ``wait`` of its counters' read.
:func:`fresh_map`, the checking aid of the geometry tail, counts as the
family ``pulsatile_fresh_map`` (one step and one launch a call).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models import pulsatile as pm
from ..models.pulsatile import PulsatileParams, PulsatileState
from ..utils.profiling import span, to_host
from . import _build
from ._checks import check_mask, check_tensors, on_card

FAMILY = "pulsatile_step"
FRESH_MAP_FAMILY = "pulsatile_fresh_map"
# kernel launches a step: the Bouzidi links of each wall, the collide-and-
# stream tile, the geometry tail and the reseed scatter
LAUNCHES_PER_STEP = 5
# the tile launch's band (TILE_Y, TILE_X in csrc/pulsatile_step.cu), rows x
# columns
TILE = (4, 64)
# bytes and operations of one float32 iteration a cell (each input read
# once, each output written once): g_coll at fluid cells or g_stream at
# solid ones and the macros read, gout, g2 and the macros written (132 B);
# about 260 operations in the collision (equilibrium, the 9 × 9 moment
# product), 55 in the streamed sums and 15 in the geometry (the Bouzidi
# links and the reseed touch O(nx) cells)
WORK_PER_CELL = (132, 330)

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
    if 9 * ny * nx >= 2 ** 31 or -(-ny // TILE[0]) > 65535:
        raise ValueError(f"{ny} x {nx} is too large for 32-bit indices "
                         "or the tile grid")
    shapes = {"g_coll": (9, ny, nx), "g_stream": (9, ny, nx), "yr1": (nx,),
              "yr2": (nx,), "P": (ny, nx), "Ux": (ny, nx), "Uy": (ny, nx),
              "F": (ny + 2, nx + 2)}
    check_tensors(*((name, getattr(state, name), shape)
                    for name, shape in shapes.items()))
    check_mask(state.fluid, state.g_coll, "fluid", torch.bool)


def run_fused_full(state: PulsatileState, t0, p: PulsatileParams,
                   n_steps: int):
    """Advance ``n_steps`` steps from step index ``t0``.  Returns
    ``(state, diag)``: ``diag`` is a CPU int64 tensor, ``diag[0]`` the
    order-dependent reseed steps (filled densely instead of sequentially)
    and ``diag[1]`` the reseeded cells.  The caller's tensors are never
    written."""
    check_params(p)
    check_state(state, p)
    if not on_card(state.g_coll, n_steps):
        st, (n_dep, n_cells) = pm.run_with_diag(state, t0, p, n_steps)
        return st, torch.tensor([n_dep, n_cells], dtype=torch.int64)
    with span("kernel.prepare", family=FAMILY, steps=n_steps):
        dtype, device = state.g_coll.dtype, state.g_coll.device
        consts = kernel_constants(p)
        ny, nx = p.ny, p.nx
        src = (state.g_coll, state.g_stream,
               torch.stack([state.P, state.Ux, state.Uy]),
               torch.stack([state.yr1, state.yr2]))
        bufs = [tuple(torch.empty_like(t) for t in src) for _ in range(2)]
        cap = 4 * nx + 256      # fresh cells a step can hold (≤ 2 per column)
        ints = dict(dtype=torch.int32, device=device)
        bz_idx = torch.empty(12 * nx, **ints)     # six slots a column and wall
        bz_val = torch.empty(12 * nx, dtype=dtype, device=device)
        rs_idx = torch.empty(cap, **ints)
        rs_val = torch.empty(9 * cap, dtype=dtype, device=device)
        ctr = torch.zeros(8, **ints)
    _build.enqueue(FAMILY, "pulsatile_run", state.g_coll, n_steps,
                   n_steps * LAUNCHES_PER_STEP,
                   [(*(t.data_ptr() for t in src),
                     *(t.data_ptr() for b in bufs for t in b),
                     bz_idx.data_ptr(), bz_val.data_ptr(), rs_idx.data_ptr(),
                     rs_val.data_ptr(), ctr.data_ptr(), ny, nx, cap, n_steps,
                     int(t0), ctypes.addressof(consts))])
    counts = to_host(ctr[:3]).to(torch.int64)
    if counts[2]:
        raise RuntimeError(f"{int(counts[2])} steps had more than {cap} "
                           "fresh cells, the kernel's list")
    if n_steps == 0:
        gc, gs, mac, yr = src[0].clone(), src[1].clone(), src[2], src[3]
    else:
        gc, gs, mac, yr = bufs[(n_steps - 1) % 2]
    F = pm.fobj_from_walls(yr[0], yr[1], p)
    return (PulsatileState(g_coll=gc, g_stream=gs, yr1=yr[0], yr2=yr[1],
                           P=mac[0], Ux=mac[1], Uy=mac[2], F=F,
                           fluid=pm.flags_from_fobj(F, p)),
            counts[:2])


def fresh_map_plain(yr, yr_new, p: PulsatileParams):
    """The cells that walls moving from ``yr`` to ``yr_new`` (each
    ``(2, nx)``: bottom, top) turn from solid to fluid, by the plain path's
    per-cell test (``models.pulsatile._reseed``): a bool ``(ny, nx)``
    map."""
    F_old = pm.fobj_from_walls(yr[0], yr[1], p)[1:-1, 1:-1]
    F_new = pm.fobj_from_walls(yr_new[0], yr_new[1], p)[1:-1, 1:-1]
    return (F_old < 1.0) & (F_new >= 1.0)


def random_walls(p: PulsatileParams, dtype, seed: int):
    """``(yr, yr_new)``, each ``(2, nx)`` on the CPU: the inputs on which
    :func:`fresh_map` is held to :func:`fresh_map_plain` — random walls
    with small moves and jumps, walls past the channel centre, on integer
    rows and just off them, far outside the lattice, infinite and NaN."""
    rng = np.random.default_rng(seed)
    nx, ny, yc = p.nx, p.ny, p.yc
    old = np.stack([rng.uniform(-6, yc + 3, nx),
                    rng.uniform(yc - 3, ny + 6, nx)])
    new = old + rng.uniform(-0.3, 0.3, old.shape)
    jump = rng.random(old.shape) < 0.15
    new[jump] = rng.uniform(-8, ny + 8, int(jump.sum()))
    rows = rng.integers(-2, ny + 2, old.shape).astype(float)
    on_row = rng.random(old.shape) < 0.1
    old[on_row] = rows[on_row]
    near = rng.random(old.shape) < 0.1
    new[near] = np.nextafter(rows[near], rng.choice([-np.inf, np.inf],
                                                    int(near.sum())))
    for a in (old, new):
        for v in (np.nan, np.inf, -np.inf, 1e30, -1e30):
            a[rng.random(a.shape) < 0.02] = v
    return (torch.from_numpy(old).to(dtype), torch.from_numpy(new).to(dtype))


def fresh_map(yr, yr_new, p: PulsatileParams):
    """:func:`fresh_map_plain` through the kernel's geometry tail on a CUDA
    tensor: the window of rows around each wall that the tail searches and
    its per-cell test (``pulsatile_fresh_map_*``); the plain version on a
    CPU tensor."""
    if not on_card(yr):
        return fresh_map_plain(yr, yr_new, p)
    if (yr.shape != (2, p.nx) or yr_new.shape != yr.shape
            or yr_new.dtype != yr.dtype or yr_new.device != yr.device
            or yr.dtype not in (torch.float32, torch.float64)):
        raise ValueError("yr and yr_new must be (2, nx) tensors of one float "
                         "dtype and device")
    yr, yr_new = yr.contiguous(), yr_new.contiguous()
    out = torch.zeros((p.ny, p.nx), dtype=torch.uint8, device=yr.device)
    consts = kernel_constants(p)
    _build.enqueue(FRESH_MAP_FAMILY, "pulsatile_fresh_map", yr, 1, 1,
                   [(yr.data_ptr(), yr_new.data_ptr(), out.data_ptr(), p.ny,
                     p.nx, ctypes.addressof(consts))])
    return out.bool()
