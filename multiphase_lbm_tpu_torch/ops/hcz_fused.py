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
"""
from __future__ import annotations

import ctypes

import torch

from ..models import hcz
from ..models.hcz import HCZParams
from ..utils.profiling import count_launches, span
from . import _grid, _halo

FAMILY = "hcz_step"
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


def check_state(f, g, ndim: int, q: int):
    """Raise unless ``f`` and ``g`` are contiguous float32/float64 tensors of
    one shape ``(q, *spatial)`` with ``ndim`` spatial axes, on one device."""
    for name, t in (("f", f), ("g", g)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} must be float32 or float64, got {t.dtype}")
        if t.ndim != ndim + 1 or t.shape[0] != q:
            raise ValueError(f"{name} must have shape ({q}, {ndim} lattice "
                             f"axes), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if g.shape != f.shape or g.dtype != f.dtype or g.device != f.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} on {g.device} does not "
                         f"match f {tuple(f.shape)} {f.dtype} on {f.device}")


def _check_mask(f, fluid_f32):
    if not isinstance(fluid_f32, torch.Tensor):
        raise TypeError("fluid_f32 must be a torch tensor")
    if fluid_f32.dtype != torch.float32:
        raise TypeError(f"fluid_f32 must be float32, got {fluid_f32.dtype}")
    if tuple(fluid_f32.shape) != tuple(f.shape[1:]):
        raise ValueError(f"fluid_f32 shape {tuple(fluid_f32.shape)} does not "
                         f"match the lattice {tuple(f.shape[1:])}")
    if fluid_f32.device != f.device:
        raise ValueError(f"f on {f.device} but fluid_f32 on {fluid_f32.device}")
    if not fluid_f32.is_contiguous():
        raise ValueError("fluid_f32 must be contiguous")


def run_fused(f, g, fluid_f32, p: HCZParams, n_steps: int):
    """Advance ``n_steps`` HCZ 2D steps; returns a new ``(f, g)``.

    Args:
      f, g: populations ``(9, ny, nx)``, float32 or float64, contiguous.
      fluid_f32: fluid mask ``(ny, nx)`` float32 (1.0 fluid / 0.0 solid).
    The caller's tensors are never written.
    """
    check_state(f, g, 2, 9)
    _check_mask(f, fluid_f32)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if f.device.type == "cpu":
        return hcz.run((f, g), fluid_f32 > 0.5, p, n_steps)
    if f.device.type != "cuda":
        raise ValueError(f"no kernel for device {f.device}")
    if n_steps == 0:
        return f.clone(), g.clone()
    return _launch(f, g, fluid_f32, p, n_steps, halo_route=False)


def _launch(f, g, fluid_f32, p: HCZParams, n_steps: int, halo_route: bool):
    """``n_steps`` kernel steps on the CUDA tensors ``(f, g)`` in one C call,
    which ping-pongs two new pairs of buffers; counts them (``.halo`` for
    the halo route)."""
    from . import _build

    with span("kernel.prepare", family=FAMILY, steps=n_steps):
        _, ny, nx = f.shape
        _grid.launch_geometry(ny, nx, TILE)
        lib = _build.load()
        run = lib.hcz_step_f32 if f.dtype == torch.float32 else lib.hcz_step_f64
        consts = kernel_constants(p)
        a = (torch.empty_like(f), torch.empty_like(g))
        b = (torch.empty_like(f), torch.empty_like(g)) if n_steps > 1 else None
        b_ptrs = (b[0].data_ptr(), b[1].data_ptr()) if b else (None, None)
    with span("kernel.enqueue", family=FAMILY, steps=n_steps):
        # the library's runtime launches into the context current on this
        # thread: make it the tensor's device
        with torch.cuda.device(f.device):
            stream = torch.cuda.current_stream(f.device).cuda_stream
            err = run(f.data_ptr(), g.data_ptr(), a[0].data_ptr(),
                      a[1].data_ptr(), *b_ptrs, fluid_f32.data_ptr(), ny, nx,
                      n_steps, ctypes.addressof(consts), stream)
    if err != 0:
        raise RuntimeError("hcz_step launch failed: "
                           + lib.sc_error_string(err).decode())
    count_launches(FAMILY, n_steps, n_steps * LAUNCHES_PER_STEP, halo_route)
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
    check_state(f_ext, g_ext, 2, 9)
    _check_mask(f_ext, fluid_ext_f32)
    halo = _halo.check(halo, REACH, nsub, f_ext.shape[1], "rows")
    if f_ext.device.type == "cpu":
        return step_halo_plain(f_ext, g_ext, fluid_ext_f32, p, nsub, halo)
    if f_ext.device.type != "cuda":
        raise ValueError(f"no kernel for device {f_ext.device}")
    out = _launch(f_ext, g_ext, fluid_ext_f32, p, nsub, halo_route=True)
    return tuple(_halo.interior(t, halo, 1) for t in out)
