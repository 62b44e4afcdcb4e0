"""Fused HCZ phase-field D3Q19 step on the GPU: wrapper of
``csrc/hcz3d_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_hcz3d.py``:
:func:`run_fused_3d` of its ``run_fused_3d`` (fully periodic box, no mask)
and :func:`step_fused_halo_3d` of its ``step_fused_halo_3d``
(``pallas_hcz3d.py:299``), the halo-in entry of the z-slab decomposition.
On a CUDA tensor both launch the hand-written kernel, two launches a step
(a φ pass, then a shared-memory tile that marches up chunks of z-planes;
see the source's header note), all steps of a call from one C call, or
raise; they never substitute the plain path for a failed build or launch.
On a CPU tensor, and only there, they run the plain PyTorch version
(:func:`..models.hcz.run` with ``three_d=True``, and
:func:`step_halo_plain_3d`).

Each call counts its steps and launches in the recorder of
:mod:`..utils.profiling` (``kernel.steps.hcz3d_step``,
``kernel.launches.hcz3d_step``, ``LAUNCHES_PER_STEP`` a step; ``.halo``
after them for :func:`step_fused_halo_3d`) and records the
``kernel.prepare`` and ``kernel.enqueue`` spans.

:func:`record_3d` is the laplace3D driver's energy record of a state
(:func:`..models.hcz.kinetic_energy` with ``three_d=True``) from the same
source's φ pass and record tile, two launches that leave one number on the
card; it counts as the family ``hcz3d_record`` (one step and
``RECORD_LAUNCHES`` launches a record).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..models import hcz
from ..models.hcz import HCZParams
from ..utils.profiling import span
from . import _build, _grid, _halo
from ._checks import check_tensors, on_card
from .hcz_fused import kernel_constants

FAMILY = "hcz3d_step"
RECORD_FAMILY = "hcz3d_record"
# z-planes of validity one step consumes.  f needs 3: u reads ∇(∇²φ), two
# planes of φ away, and the pull streaming one more.  g needs one more: its
# forcing reads E = ∇(P − ρ/3), and P one plane away reads that u.  So
# nsub steps need 3·nsub + 1 planes; 4·nsub covers them.  The Pallas
# entry's HALO = 3 (pallas_hcz3d.py:27) is one plane short for g (errors
# up to 9e-11 in float64 at nsub 1 on a noisy droplet, below float32's
# rounding on the 128³ droplet).
REACH = 4
# bytes and operations of one float32 step a cell (each input read once,
# each output written once): f and g read and written (2 × 19 populations),
# about 1,300 operations
WORK_PER_CELL = (304, 1300)
# the kernel's block tile (TILE_Y, TILE_X in csrc/hcz3d_step.cu), rows x
# columns, and the z-planes a block marches up (ZC)
TILE = (8, 32)
ZC = 16
# kernel launches a step: the φ pass and the tile
LAUNCHES_PER_STEP = 2
# kernel launches a record: the φ pass and the record tile
RECORD_LAUNCHES = 2


def _check_state(f, g):
    check_tensors(("f", f, (19, None, None, None)),
                  ("g", g, (19, None, None, None)))


def run_fused_3d(f, g, p: HCZParams, n_steps: int):
    """Advance ``n_steps`` periodic HCZ 3D steps; returns a new ``(f, g)``.

    Args:
      f, g: populations ``(19, nz, ny, nx)``, float32 or float64, contiguous.
    The caller's tensors are never written.
    """
    _check_state(f, g)
    if not on_card(f, n_steps):
        fluid = torch.ones(f.shape[1:], dtype=torch.bool)
        return hcz.run((f, g), fluid, p, n_steps, lattice=hcz.D3Q19,
                       three_d=True)
    if n_steps == 0:
        return f.clone(), g.clone()
    return _launch(f, g, p, n_steps, halo_route=False)


def _launch(f, g, p: HCZParams, n_steps: int, halo_route: bool):
    """``n_steps`` kernel steps on the CUDA tensors ``(f, g)`` in one C call,
    which ping-pongs two new pairs of buffers; counts them (``.halo`` for
    the halo route)."""
    with span("kernel.prepare", family=FAMILY, steps=n_steps):
        _, nz, ny, nx = f.shape
        _grid.launch_geometry_3d(nz, ny, nx, TILE, ZC)
        consts = kernel_constants(p)
        a = (torch.empty_like(f), torch.empty_like(g))
        b = (torch.empty_like(f), torch.empty_like(g)) if n_steps > 1 else None
        b_ptrs = (b[0].data_ptr(), b[1].data_ptr()) if b else (None, None)
        phi = torch.empty(f.shape[1:], dtype=f.dtype, device=f.device)
    _build.enqueue(FAMILY, "hcz3d_step", f, n_steps,
                   n_steps * LAUNCHES_PER_STEP,
                   [(f.data_ptr(), g.data_ptr(), a[0].data_ptr(),
                     a[1].data_ptr(), *b_ptrs, phi.data_ptr(), nz, ny, nx,
                     n_steps, ctypes.addressof(consts))], halo_route)
    return a if n_steps % 2 else b


def step_halo_plain_3d(f_ext, g_ext, p: HCZParams, nsub: int = 1, halo=None):
    """The plain version of :func:`step_fused_halo_3d`, on any device:
    ``nsub`` plain steps of the whole slab, then its interior z-planes."""
    halo = _halo.check(halo, REACH, nsub, f_ext.shape[1], "z-planes")
    fluid = torch.ones(f_ext.shape[1:], dtype=torch.bool, device=f_ext.device)
    out = hcz.run((f_ext, g_ext), fluid, p, nsub, lattice=hcz.D3Q19,
                  three_d=True)
    return tuple(_halo.interior(t, halo, 1) for t in out)


def step_fused_halo_3d(f_ext, g_ext, p: HCZParams, nsub: int = 1, halo=None):
    """``nsub`` periodic HCZ 3D steps on z-slabs whose halo planes are
    already filled; returns the interior ``(f, g)``, each
    ``(19, nz_ext − 2·halo, ny, nx)``.

    ``halo`` z-planes on each side, ``REACH · nsub`` by default (one plane
    a sub-step wider than the Pallas entry's fixed width,
    ``pallas_hcz3d.py:307``; see ``REACH``); a wider halo gives the same
    interior.  The kernel wraps its z index at the slab's
    ends; those planes reach at most ``REACH · nsub`` planes in, all of
    them cropped.
    """
    _check_state(f_ext, g_ext)
    halo = _halo.check(halo, REACH, nsub, f_ext.shape[1], "z-planes")
    if not on_card(f_ext):
        return step_halo_plain_3d(f_ext, g_ext, p, nsub, halo)
    out = _launch(f_ext, g_ext, p, nsub, halo_route=True)
    return tuple(_halo.interior(t, halo, 1) for t in out)


def record_3d(f, g, p: HCZParams):
    """The energy record of the state ``(f, g)``: a float64 tensor ``[E]``
    on its device.

    ``E`` is :func:`..models.hcz.kinetic_energy` with ``three_d=True`` over
    the fully periodic box (½ Σ|u|² over ``nz·ny·nx``).  On a CUDA tensor
    the step's φ pass and one launch of the record tile, which forms u as
    the step does and sums |u|² in double in a fixed order, or raise; on a
    CPU tensor, and only there, the plain value.  Nothing is read to the
    host here.
    """
    _check_state(f, g)
    if not on_card(f):
        fluid = torch.ones(f.shape[1:], dtype=torch.bool)
        e = hcz.kinetic_energy((f, g), fluid, p, hcz.D3Q19, three_d=True)
        return e.to(torch.float64).reshape(1)
    with span("kernel.prepare", family=RECORD_FAMILY, steps=1):
        _, nz, ny, nx = f.shape
        grid = _grid.launch_geometry_3d(nz, ny, nx, TILE, ZC)
        consts = kernel_constants(p)
        phi = torch.empty(f.shape[1:], dtype=f.dtype, device=f.device)
        ws = torch.empty(math.prod(grid) + 1, dtype=torch.float64,
                         device=f.device)
        out = torch.empty(1, dtype=torch.float64, device=f.device)
    _build.enqueue(RECORD_FAMILY, "hcz3d_record", f, 1, RECORD_LAUNCHES,
                   [(f.data_ptr(), g.data_ptr(), phi.data_ptr(),
                     ws.data_ptr(), out.data_ptr(), nz, ny, nx,
                     ctypes.addressof(consts))])
    return out
