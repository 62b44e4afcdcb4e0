"""Fused Shan–Chen D2Q9 step on the GPU: wrapper of ``csrc/sc_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_sc.py``: :func:`run_fused`
of its ``run_fused`` and :func:`step_fused_halo` of its ``step_fused_halo``
(``pallas_sc.py:326``), the halo-in entry of the lattice decomposition.  On
a CUDA tensor both launch the hand-written kernel, one launch a step (a
shared-memory tile per block; see the source's header note), all steps of
a call from one C call, or raise; they never substitute the plain path for
a failed build or launch.  On a CPU tensor, and only there, they run the
plain PyTorch version (:func:`..models.shan_chen.run`, and
:func:`step_halo_plain`), which is what the CPU tests exercise.  The
kernel takes both ψ forms of the model (``psi_mode`` ``"yuan"`` and
``"const_g"``) and the per-node body force ``gx_u``/``gy_u``, which the
Pallas kernel refuses.

Each call counts its steps and launches in the recorder of
:mod:`..utils.profiling` (``kernel.steps.sc_step``,
``kernel.launches.sc_step``; ``.halo`` after them for
:func:`step_fused_halo`), so a run can show that its main path went through
the kernel, and records the ``kernel.prepare`` and ``kernel.enqueue`` spans.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import eos
from ..core.collision import MRT_M_I, MRT_M_I_INV
from ..models import shan_chen as sc
from ..models.shan_chen import SCParams
from ..utils.profiling import count_launches, span
from . import _grid, _halo

FAMILY = "sc_step"
# kernel launches a step
LAUNCHES_PER_STEP = 1
# rows of validity one step consumes: the force reads ψ one row away and
# the pull streaming one row more
REACH = 2
# bytes and operations of one float32 step a cell (each input read once,
# each output written once): 9 populations read and written (no mask when
# periodic), about 200 operations
WORK_PER_CELL = (72, 200)
# the kernel's block tile (TILE_Y, TILE_X in csrc/sc_step.cu), rows x columns
TILE = (8, 32)
PSI_MODES = ("yuan", "const_g")


class _SCConst(ctypes.Structure):
    """Mirror of ``struct SCConst`` in ``csrc/sc_step.cu`` (same order)."""
    _fields_ = [(name, ctypes.c_double) for name in (
        "R", "Tt", "RT", "a", "cs2", "p_shift", "wall_c", "psi_w_fixed",
        "G", "absG_cs2", "psi_w_cg", "gx", "gravity", "gx_u", "gy_u", "tau",
        "omega", "one_minus_omega", "omega_minus_one")] + [
        (name, ctypes.c_double * 9) for name in ("m7", "m8", "mi7", "mi8")] + [
        (name, ctypes.c_int) for name in ("center_branch", "mrt", "psi_mode")]


def check_params(p: SCParams):
    """Fail loudly on a ψ form the kernel does not implement (the model's
    own two: ``"yuan"`` and ``"const_g"``)."""
    if p.psi_mode not in PSI_MODES:
        raise NotImplementedError(
            f"fused SC kernel implements psi_mode {PSI_MODES}, "
            f"got {p.psi_mode!r}")


def _psi_cg(rho: float, p: SCParams) -> float:
    """The constant-G ψ of ``models.shan_chen.sc_force`` at one density,
    in float64 on the host."""
    S = eos.CS2 * rho - (eos.yuan_pressure(rho, p.a, p.R, p.T) + p.p_shift)
    return math.sqrt(max(2.0 * S / (abs(p.G) * eos.CS2), 0.0))


def kernel_constants(p: SCParams) -> _SCConst:
    """Host-side constants of one parameter set, in float64 (the kernel
    rounds them to its working type, as JAX rounds Python floats)."""
    R, T, a = p.R, p.T, p.a
    Zw = float(eos.yuan_Z(p.rho_w))
    psi_w_fixed = float(eos.yuan_psi(torch.tensor(p.rho_w, dtype=torch.float64),
                                     a, R, T, p.p_shift))
    c = _SCConst(
        R=R, Tt=T, RT=R * T, a=a, cs2=eos.CS2, p_shift=p.p_shift,
        wall_c=(6.0 * p.rho_w * (R * T * Zw - a * p.rho_w - eos.CS2)
                + 6.0 * p.p_shift),
        psi_w_fixed=psi_w_fixed, G=p.G, absG_cs2=abs(p.G) * eos.CS2,
        psi_w_cg=_psi_cg(p.rho_w, p), gx=p.gx, gravity=p.gravity, gx_u=p.gx_u,
        gy_u=p.gy_u, tau=1.0 / p.omega, omega=p.omega,
        one_minus_omega=1.0 - p.omega, omega_minus_one=p.omega - 1.0,
        center_branch=int(p.wall_psi_center_branch),
        mrt=int(p.collision == "mrt"),
        psi_mode=PSI_MODES.index(p.psi_mode))
    # S = diag(1,…,1,ω,ω) ⇒ M⁻¹SM = I + (ω−1)·M⁻¹[:,7:9] M[7:9,:]: the
    # dense moment transform reduces to two contractions + two rank-1 updates
    for name, vals in (("m7", MRT_M_I[7]), ("m8", MRT_M_I[8]),
                       ("mi7", MRT_M_I_INV[:, 7]), ("mi8", MRT_M_I_INV[:, 8])):
        getattr(c, name)[:] = [float(v) for v in vals]
    return c


def _check_state(f, fluid_f32):
    if not isinstance(f, torch.Tensor) or not isinstance(fluid_f32, torch.Tensor):
        raise TypeError("f and fluid_f32 must be torch tensors")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"f must be float32 or float64, got {f.dtype}")
    if f.ndim != 3 or f.shape[0] != 9:
        raise ValueError(f"f must have shape (9, ny, nx), got {tuple(f.shape)}")
    if fluid_f32.dtype != torch.float32:
        raise TypeError(f"fluid_f32 must be float32, got {fluid_f32.dtype}")
    if tuple(fluid_f32.shape) != tuple(f.shape[1:]):
        raise ValueError(f"fluid_f32 shape {tuple(fluid_f32.shape)} does not "
                         f"match the lattice {tuple(f.shape[1:])}")
    if fluid_f32.device != f.device:
        raise ValueError(f"f on {f.device} but fluid_f32 on {fluid_f32.device}")
    if not (f.is_contiguous() and fluid_f32.is_contiguous()):
        raise ValueError("f and fluid_f32 must be contiguous")


def run_fused(f, fluid_f32, p: SCParams, n_steps: int, periodic: bool = False):
    """Advance ``n_steps`` Shan–Chen steps; returns a new tensor.

    Args:
      f: populations ``(9, ny, nx)``, float32 or float64, contiguous.
      fluid_f32: fluid mask ``(ny, nx)`` float32 (1.0 fluid / 0.0 solid).
      p: model params (``psi_mode`` ``"yuan"`` or ``"const_g"``).
      periodic: fully fluid domain; the kernel then reads no mask.
    The caller's ``f`` is never written.
    """
    check_params(p)
    _check_state(f, fluid_f32)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if f.device.type == "cpu":
        fluid = (torch.ones_like(fluid_f32, dtype=torch.bool) if periodic
                 else fluid_f32 > 0.5)
        return sc.run(f, fluid, p, n_steps)
    if f.device.type != "cuda":
        raise ValueError(f"no kernel for device {f.device}")
    if n_steps == 0:
        return f.clone()
    return _launch(f, fluid_f32, p, n_steps, periodic, halo_route=False)


def _launch(f, fluid_f32, p: SCParams, n_steps: int, periodic: bool,
            halo_route: bool):
    """``n_steps`` kernel steps on the CUDA tensor ``f`` in one C call,
    which ping-pongs two new buffers; counts them (``.halo`` for the halo
    route)."""
    from . import _build

    with span("kernel.prepare", family=FAMILY, steps=n_steps):
        _, ny, nx = f.shape
        _grid.launch_geometry(ny, nx, TILE)
        lib = _build.load()
        run = lib.sc_step_f32 if f.dtype == torch.float32 else lib.sc_step_f64
        consts = kernel_constants(p)
        a = torch.empty_like(f)
        b = torch.empty_like(f) if n_steps > 1 else None
        mask_ptr = None if periodic else fluid_f32.data_ptr()
    with span("kernel.enqueue", family=FAMILY, steps=n_steps):
        # the library's runtime launches into the context current on this
        # thread: make it the tensor's device
        with torch.cuda.device(f.device):
            stream = torch.cuda.current_stream(f.device).cuda_stream
            err = run(f.data_ptr(), a.data_ptr(), b.data_ptr() if b is not None
                      else None, mask_ptr, ny, nx, int(periodic), n_steps,
                      ctypes.addressof(consts), stream)
    if err != 0:
        raise RuntimeError("sc_step launch failed: "
                           + lib.sc_error_string(err).decode())
    count_launches(FAMILY, n_steps, n_steps * LAUNCHES_PER_STEP, halo_route)
    return a if n_steps % 2 else b


def step_halo_plain(f_ext, fluid_ext_f32, p: SCParams, nsub: int = 1,
                    halo=None):
    """The plain version of :func:`step_fused_halo`, on any device:
    ``nsub`` plain steps of the whole slab, then its interior rows."""
    halo = _halo.check(halo, REACH, nsub, f_ext.shape[1], "rows")
    return _halo.interior(sc.run(f_ext, fluid_ext_f32 > 0.5, p, nsub), halo, 1)


def step_fused_halo(f_ext, fluid_ext_f32, p: SCParams, nsub: int = 1,
                    halo=None):
    """``nsub`` steps on a slab whose halo rows are already filled; returns
    the interior ``(9, ny_ext − 2·halo, nx)``, a new tensor.

    Args:
      f_ext: populations ``(9, ny_ext, nx)`` with ``halo`` rows above and
        below the shard's own rows (float32 or float64, contiguous).
      fluid_ext_f32: the fluid mask of the same rows, float32.
      halo: rows on each side, at least ``REACH · nsub`` (the default); a
        wider halo gives the same interior.  The Pallas kernel's 8-row
        minimum is a Mosaic sublane rule and does not apply here.
    The kernel runs on the whole slab and wraps its row index at the slab's
    edges; the rows that wrap reach at most ``REACH · nsub`` rows in, all of
    them cropped.
    """
    check_params(p)
    _check_state(f_ext, fluid_ext_f32)
    halo = _halo.check(halo, REACH, nsub, f_ext.shape[1], "rows")
    if f_ext.device.type == "cpu":
        return step_halo_plain(f_ext, fluid_ext_f32, p, nsub, halo)
    if f_ext.device.type != "cuda":
        raise ValueError(f"no kernel for device {f_ext.device}")
    return _halo.interior(
        _launch(f_ext, fluid_ext_f32, p, nsub, periodic=False,
                halo_route=True),
        halo, 1)
