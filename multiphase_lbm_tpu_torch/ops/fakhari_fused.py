"""Fused Fakhari conservative phase-field D2Q9 step on the GPU: wrapper of
``csrc/fakhari_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_fakhari.py``:
:func:`run_fused` of its ``run_fused`` and :func:`step_fused_halo` of its
``step_fused_halo`` (``pallas_fakhari.py:354``), the halo-in entry of the
lattice decomposition.  The lattice is periodic, as there: there is no
geometry argument.  On a CUDA tensor both launch the hand-written kernel
once per step (a shared-memory tile that forms φ, does the previous step's
velocity update, collides and streams), plus one velocity pass at the end
of each call (see the source's header note), or raise; they never
substitute the plain path for a failed build or launch.  On a CPU tensor,
and only there, they run the plain PyTorch version
(:func:`..models.fakhari.run`, and :func:`step_halo_plain`), which is what
the CPU tests exercise.

Each call counts its steps and launches in the recorder of
:mod:`..utils.profiling` (``kernel.steps.fakhari_step``,
``kernel.launches.fakhari_step``; ``.halo`` after them for
:func:`step_fused_halo`), so a run can show that its main path went through
the kernel, and records the ``kernel.prepare`` and ``kernel.enqueue`` spans.
"""
from __future__ import annotations

import ctypes

import torch

from ..models import fakhari as fk
from ..models.fakhari import FakhariParams
from ..utils.profiling import span
from . import _build, _grid, _halo
from ._checks import check_tensors, on_card

FAMILY = "fakhari_step"
# kernel launches a step (the tile, which also does the previous step's
# velocity update), and the velocity pass that ends each call
LAUNCHES_PER_STEP = 1
LAUNCHES_PER_CALL = 1
# the kernel's block tile (TILE_Y, TILE_X in csrc/fakhari_step.cu), rows x
# columns
TILE = (8, 32)
# the C entry's mode (FIRST, STEP, VELOCITY in the source): collide at the
# input u; update u, then collide; update u only
FIRST, STEP, VELOCITY = 0, 1, 2
# rows of validity one step consumes: the collision reads ∇φ, ∇²φ and the
# stress two rows away, the streaming one more, and the velocity update
# after it ∇φ of the streamed φ two more (pallas_fakhari.py:63)
REACH = 5
# bytes and operations of one float32 step a cell (each input read once,
# each output written once): h, g (2 × 9) and u (2) read and written, about
# 750 operations (the fields once; the stress and the force twice: at the
# stored u for the deferred velocity update, and at the updated u for the
# collision)
WORK_PER_CELL = (160, 750)


class _FakhariConst(ctypes.Structure):
    """Mirror of ``struct FakhariConst`` in ``csrc/fakhari_step.cu`` (same
    order)."""
    _fields_ = [(name, ctypes.c_double) for name in (
        "rhol", "drho", "four_beta", "kappa", "W", "wc", "one_minus_wc",
        "s8", "one_minus_s8", "fac", "drho3")]


def kernel_constants(p: FakhariParams) -> _FakhariConst:
    """Host-side constants of one parameter set, in float64 (the kernel
    rounds them to its working type, as JAX rounds Python floats)."""
    return _FakhariConst(
        rhol=p.rhol, drho=p.rhoh - p.rhol, four_beta=4.0 * p.beta,
        kappa=p.kappa, W=p.W, wc=p.wc, one_minus_wc=1.0 - p.wc, s8=p.s8,
        one_minus_s8=1.0 - p.s8, fac=(0.5 - p.tau) / p.tau, drho3=p.drho3)


def _check_state(h, g, u):
    """Raise unless ``h`` and ``g`` are ``(9, ny, nx)`` and ``u`` is
    ``(2, ny, nx)``, all contiguous, of one float32/float64 dtype, on one
    device."""
    check_tensors(("h", h, (9, None, None)), ("g", g, (9, None, None)),
                  ("u", u, (2, None, None)))


def run_fused(h, g, u, p: FakhariParams, n_steps: int):
    """Advance ``n_steps`` Fakhari steps on the periodic lattice; returns a
    new ``(h, g, u)``.  The caller's tensors are never written."""
    _check_state(h, g, u)
    if not on_card(h, n_steps):
        return fk.run((h, g, u), p, n_steps)
    if n_steps == 0:
        return h.clone(), g.clone(), u.clone()
    return _launch(h, g, u, p, n_steps, halo_route=False)


def _launch(h, g, u, p: FakhariParams, n_steps: int, halo_route: bool):
    """``n_steps`` kernel steps on the CUDA tensors ``(h, g, u)`` and the
    velocity pass, ping-ponging two new sets of buffers; counts them
    (``.halo`` for the halo route)."""
    with span("kernel.prepare", family=FAMILY, steps=n_steps):
        _grid.launch_geometry(h.shape[1], h.shape[2], TILE)
        consts = kernel_constants(p)
        bufs = tuple(tuple(torch.empty_like(t) for t in (h, g, u))
                     for _ in range(2))
    _build.enqueue(FAMILY, "fakhari_step", h, n_steps,
                   n_steps * LAUNCHES_PER_STEP + LAUNCHES_PER_CALL,
                   step_calls((h, g, u), bufs, n_steps, consts), halo_route)
    return result(bufs, n_steps)


def step_calls(state, bufs, n_steps: int, consts: _FakhariConst):
    """The C entry's arguments (the stream left out) for ``n_steps`` steps
    of ``state`` into the two buffer triples ``bufs``: step ``i`` writes
    ``bufs[i % 2]`` (mode FIRST, then STEP), and the velocity pass writes
    the u of ``bufs[n_steps % 2]``.  A generator: each step's arguments
    are formed as the caller's loop reaches it."""
    ny, nx = state[0].shape[1:]
    src = tuple(state)
    for i in range(n_steps):
        dst = bufs[i % 2]
        yield (*(t.data_ptr() for t in src + dst), ny, nx,
               STEP if i else FIRST, ctypes.addressof(consts))
        src = dst
    yield (*(t.data_ptr() for t in src), None, None,
           bufs[n_steps % 2][2].data_ptr(), ny, nx, VELOCITY,
           ctypes.addressof(consts))


def result(bufs, n_steps: int):
    """The state that :func:`step_calls` leaves in ``bufs``: the last
    step's ``(h, g)`` and the velocity pass's u."""
    out = bufs[(n_steps - 1) % 2]
    return out[0], out[1], bufs[n_steps % 2][2]


def step_halo_plain(h_ext, g_ext, u_ext, p: FakhariParams, nsub: int = 1,
                    halo=None):
    """The plain version of :func:`step_fused_halo`, on any device:
    ``nsub`` plain steps of the whole slab, then its interior rows."""
    halo = _halo.check(halo, REACH, nsub, h_ext.shape[1], "rows")
    out = fk.run((h_ext, g_ext, u_ext), p, nsub)
    return tuple(_halo.interior(t, halo, 1) for t in out)


def step_fused_halo(h_ext, g_ext, u_ext, p: FakhariParams, nsub: int = 1,
                    halo=None):
    """``nsub`` Fakhari steps on slabs whose halo rows are already filled;
    returns the interior ``(h, g, u)``, each ``ny_ext − 2·halo`` rows.

    ``halo`` rows on each side, at least ``REACH · nsub`` (the default); a
    wider halo gives the same interior (the Pallas path rounds it up to 8
    rows, a Mosaic sublane rule).  Like :func:`run_fused`, a call opens
    with one φ pass over the whole slab.  The kernel wraps its row index at
    the slab's edges; those rows reach at most ``REACH · nsub`` rows in, all
    of them cropped.
    """
    _check_state(h_ext, g_ext, u_ext)
    halo = _halo.check(halo, REACH, nsub, h_ext.shape[1], "rows")
    if not on_card(h_ext):
        return step_halo_plain(h_ext, g_ext, u_ext, p, nsub, halo)
    out = _launch(h_ext, g_ext, u_ext, p, nsub, halo_route=True)
    return tuple(_halo.interior(t, halo, 1) for t in out)
