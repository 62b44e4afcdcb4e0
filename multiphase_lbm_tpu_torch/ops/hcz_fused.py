"""Fused HCZ phase-field D2Q9 step on the GPU: wrapper of ``csrc/hcz_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_hcz.py``: :func:`run_fused`
of its ``run_fused`` and :func:`step_fused_halo` of its ``step_fused_halo``
(``pallas_hcz.py:318``), the halo-in entry of the lattice decomposition.  On
a CUDA tensor both launch the hand-written kernel, one launch a step (a
shared-memory tile per block; see the source's header note), all steps of
a call from one C call, or raise; they never substitute the plain path for
a failed build or launch.  On a CPU tensor, and only there, they run the
plain PyTorch version (:func:`..models.hcz.run`, and
:func:`step_halo_plain`), which is what the CPU tests exercise.  Any row
count works: the kernel needs none of the Pallas path's 8-row padding.

Each call counts its steps and launches in the recorder of
:mod:`..utils.profiling` (``kernel.steps.hcz_step``,
``kernel.launches.hcz_step``; ``.halo`` after them for
:func:`step_fused_halo`), so a run can show that its main path went through
the kernel, and records the ``kernel.prepare`` and ``kernel.enqueue`` spans.

:func:`record_2d` is the drivers' energy and spike/bubble record of a state
(:func:`..models.hcz.kinetic_energy` and :func:`..models.hcz.interface_heights`)
from the same source's record kernel, one launch that leaves three numbers
on the card; it counts as the family ``hcz_record`` (one step and one launch
a record).
"""
from __future__ import annotations

import ctypes

import torch

from ..models import hcz
from ..models.hcz import HCZParams
from ..utils.profiling import span
from . import _build, _grid, _halo
from ._checks import check_mask, check_tensors, on_card

FAMILY = "hcz_step"
RECORD_FAMILY = "hcz_record"
# kernel launches a step
LAUNCHES_PER_STEP = 1
# rows of validity one step consumes: ∇(∇²φ) reads two rows away and the
# pull streaming one row more (pallas_hcz.py:39)
REACH = 3
# bytes and operations of one float32 step a cell (each input read once,
# each output written once): f and g read and written (2 × 9 populations)
# and the mask read, about 600 operations
WORK_PER_CELL = (148, 600)
# the kernel's block tile (TILE_Y, TILE_X in csrc/hcz_step.cu), rows x columns
TILE = (8, 32)


class _HCZConst(ctypes.Structure):
    """Mirror of ``struct HCZConst`` in ``csrc/hcz_step.cu`` (same order);
    ``csrc/hcz3d_step.cu`` shares the layout."""
    _fields_ = [(name, ctypes.c_double) for name in (
        "omega", "one_minus_omega", "half", "phi_g", "rho_g", "drho_dphi",
        "a", "b_quarter", "kappa", "gravity", "gx", "Gx_const")]


def kernel_constants(p: HCZParams) -> _HCZConst:
    """Host-side constants of one parameter set, in float64 (the kernel
    rounds them to its working type, as JAX rounds Python floats)."""
    return _HCZConst(
        omega=p.omega, one_minus_omega=1.0 - p.omega, half=1.0 - 0.5 * p.omega,
        phi_g=p.phi_g, rho_g=p.rho_g,
        drho_dphi=(p.rho_l - p.rho_g) / (p.phi_l - p.phi_g),
        a=p.a, b_quarter=p.b / 4.0, kappa=p.kappa, gravity=p.gravity,
        gx=p.gx, Gx_const=p.Gx_const)


def run_fused(f, g, fluid_f32, p: HCZParams, n_steps: int):
    """Advance ``n_steps`` HCZ 2D steps; returns a new ``(f, g)``.

    Args:
      f, g: populations ``(9, ny, nx)``, float32 or float64, contiguous.
      fluid_f32: fluid mask ``(ny, nx)`` float32 (1.0 fluid / 0.0 solid).
    The caller's tensors are never written.
    """
    check_tensors(("f", f, (9, None, None)), ("g", g, (9, None, None)))
    check_mask(fluid_f32, f)
    if not on_card(f, n_steps):
        return hcz.run((f, g), fluid_f32 > 0.5, p, n_steps)
    if n_steps == 0:
        return f.clone(), g.clone()
    return _launch(f, g, fluid_f32, p, n_steps, halo_route=False)


def _launch(f, g, fluid_f32, p: HCZParams, n_steps: int, halo_route: bool):
    """``n_steps`` kernel steps on the CUDA tensors ``(f, g)`` in one C call,
    which ping-pongs two new pairs of buffers; counts them (``.halo`` for
    the halo route)."""
    with span("kernel.prepare", family=FAMILY, steps=n_steps):
        _, ny, nx = f.shape
        _grid.launch_geometry(ny, nx, TILE)
        consts = kernel_constants(p)
        a = (torch.empty_like(f), torch.empty_like(g))
        b = (torch.empty_like(f), torch.empty_like(g)) if n_steps > 1 else None
        b_ptrs = (b[0].data_ptr(), b[1].data_ptr()) if b else (None, None)
    _build.enqueue(FAMILY, "hcz_step", f, n_steps,
                   n_steps * LAUNCHES_PER_STEP,
                   [(f.data_ptr(), g.data_ptr(), a[0].data_ptr(),
                     a[1].data_ptr(), *b_ptrs, fluid_f32.data_ptr(), ny, nx,
                     n_steps, ctypes.addressof(consts))], halo_route)
    return a if n_steps % 2 else b


def step_halo_plain(f_ext, g_ext, fluid_ext_f32, p: HCZParams, nsub: int = 1,
                    halo=None):
    """The plain version of :func:`step_fused_halo`, on any device:
    ``nsub`` plain steps of the whole slab, then its interior rows."""
    halo = _halo.check(halo, REACH, nsub, f_ext.shape[1], "rows")
    out = hcz.run((f_ext, g_ext), fluid_ext_f32 > 0.5, p, nsub)
    return tuple(_halo.interior(t, halo, 1) for t in out)


def step_fused_halo(f_ext, g_ext, fluid_ext_f32, p: HCZParams, nsub: int = 1,
                    halo=None):
    """``nsub`` HCZ 2D steps on slabs whose halo rows are already filled;
    returns the interior ``(f, g)``, each ``(9, ny_ext − 2·halo, nx)``.

    ``halo`` rows on each side, at least ``REACH · nsub`` (the default); a
    wider halo gives the same interior.  The Pallas kernel's rounding to 8
    rows is a Mosaic sublane rule and does not apply here.  The kernel runs
    on the whole slab and wraps its row index at the slab's edges; those
    rows reach at most ``REACH · nsub`` rows in, all of them cropped.
    """
    check_tensors(("f_ext", f_ext, (9, None, None)),
                  ("g_ext", g_ext, (9, None, None)))
    check_mask(fluid_ext_f32, f_ext, "fluid_ext_f32")
    halo = _halo.check(halo, REACH, nsub, f_ext.shape[1], "rows")
    if not on_card(f_ext):
        return step_halo_plain(f_ext, g_ext, fluid_ext_f32, p, nsub, halo)
    out = _launch(f_ext, g_ext, fluid_ext_f32, p, nsub, halo_route=True)
    return tuple(_halo.interior(t, halo, 1) for t in out)


def record_2d(f, g, fluid_f32, p: HCZParams, heights=False):
    """The record of the state ``(f, g)``: a float64 tensor on its device,
    ``[E]``, or ``[E, spike, bubble]`` with ``heights``.

    ``E`` is :func:`..models.hcz.kinetic_energy` (½ Σ|u|² over the fluid
    over ``fluid_f32.numel()``), and ``spike, bubble`` are
    :func:`..models.hcz.interface_heights`: the largest y in [1, ny − 2]
    with φ ≤ (φ_l + φ_g)/2 at x = nx/2 and at x = 0, or 0.  On a CUDA
    tensor one launch of the record kernel (its sum in double, in a fixed
    order), or raise; on a CPU tensor, and only there, the plain functions'
    values.  Nothing is read to the host here.
    """
    check_tensors(("f", f, (9, None, None)), ("g", g, (9, None, None)))
    check_mask(fluid_f32, f)
    _, ny, nx = f.shape
    if not on_card(f):
        e = float(hcz.kinetic_energy((f, g), fluid_f32 > 0.5, p))
        h = (hcz.interface_heights(hcz.order_parameter(f).numpy(), p)
             if heights else ())
        return torch.tensor([e, *h], dtype=torch.float64)
    with span("kernel.prepare", family=RECORD_FAMILY, steps=1):
        tiles = _grid.launch_geometry(ny, nx, TILE)
        consts = kernel_constants(p)
        ws = torch.empty(2 * tiles[0] * tiles[1] + 1, dtype=torch.float64,
                         device=f.device)
        out = torch.empty(3, dtype=torch.float64, device=f.device)
    _build.enqueue(RECORD_FAMILY, "hcz_record", f, 1, 1,
                   [(f.data_ptr(), g.data_ptr(), fluid_f32.data_ptr(),
                     ws.data_ptr(), out.data_ptr(), ny, nx,
                     ctypes.addressof(consts), 0.5 * (p.phi_l + p.phi_g))])
    return out if heights else out[:1]
