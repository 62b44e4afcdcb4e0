"""Fused Shan–Chen D2Q9 step on the GPU: wrapper of ``csrc/sc_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_sc.py``: :func:`run_fused`
of its ``run_fused`` and :func:`step_fused_halo` of its ``step_fused_halo``
(``pallas_sc.py:326``), the halo-in entry of the lattice decomposition.  On
a CUDA tensor both launch the hand-written kernel once per step (a ψ pass
and a collide-and-stream pass; see the source's header note) or raise; they
never substitute the plain path for a failed build or launch.  On a CPU
tensor, and only there, they run the plain PyTorch version
(:func:`..models.shan_chen.run`, and :func:`step_halo_plain`), which is
what the CPU tests exercise.

``LAUNCHES`` counts kernel steps launched by :func:`run_fused` in this
process (one per step, each a ψ launch plus a collide-and-stream launch),
and ``HALO_LAUNCHES`` those launched by :func:`step_fused_halo`, so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import eos
from ..core.collision import MRT_M_I, MRT_M_I_INV
from ..models import shan_chen as sc
from ..models.shan_chen import SCParams
from . import _halo

LAUNCHES = 0
HALO_LAUNCHES = 0
# rows of validity one step consumes: the force reads ψ one row away and
# the pull streaming one row more
REACH = 2


class _SCConst(ctypes.Structure):
    """Mirror of ``struct SCConst`` in ``csrc/sc_step.cu`` (same order)."""
    _fields_ = [(name, ctypes.c_double) for name in (
        "R", "Tt", "RT", "a", "cs2", "p_shift", "wall_c", "psi_w_fixed",
        "gx", "gravity", "tau", "omega", "one_minus_omega",
        "omega_minus_one")] + [
        (name, ctypes.c_double * 9) for name in ("m7", "m8", "mi7", "mi8")] + [
        ("center_branch", ctypes.c_int), ("mrt", ctypes.c_int)]


def check_params(p: SCParams):
    """The kernel implements only the Yuan–CS branch with ρ-scaled body
    forces; fail loudly on params it would silently mis-simulate."""
    if p.psi_mode != "yuan" or p.gx_u != 0.0 or p.gy_u != 0.0:
        raise NotImplementedError(
            "fused SC kernel supports psi_mode='yuan' with gx_u=gy_u=0 only "
            f"(got psi_mode={p.psi_mode!r}, gx_u={p.gx_u}, gy_u={p.gy_u}); "
            "run the layered-flow configuration through models.shan_chen.run")


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
        psi_w_fixed=psi_w_fixed, gx=p.gx, gravity=p.gravity, tau=1.0 / p.omega,
        omega=p.omega, one_minus_omega=1.0 - p.omega,
        omega_minus_one=p.omega - 1.0,
        center_branch=int(p.wall_psi_center_branch),
        mrt=int(p.collision == "mrt"))
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
      p: model params (``psi_mode='yuan'``, ``gx_u = gy_u = 0``).
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
    """``n_steps`` kernel steps on the CUDA tensor ``f``, ping-ponging two
    new buffers; counts each in ``HALO_LAUNCHES`` or ``LAUNCHES``."""
    global LAUNCHES, HALO_LAUNCHES
    from . import _build

    lib = _build.load()
    step = lib.sc_step_f32 if f.dtype == torch.float32 else lib.sc_step_f64
    consts = kernel_constants(p)
    _, ny, nx = f.shape
    bufs = (torch.empty_like(f), torch.empty_like(f))
    psi = torch.empty((ny, nx), dtype=f.dtype, device=f.device)
    mask_ptr = None if periodic else fluid_f32.data_ptr()
    src = f
    # the library's runtime launches into the context current on this
    # thread: make it the tensor's device
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        for i in range(n_steps):
            dst = bufs[i % 2]
            err = step(src.data_ptr(), dst.data_ptr(), psi.data_ptr(),
                       mask_ptr, ny, nx, int(periodic),
                       ctypes.addressof(consts), stream)
            if err != 0:
                raise RuntimeError("sc_step launch failed: "
                                   + lib.sc_error_string(err).decode())
            if halo_route:
                HALO_LAUNCHES += 1
            else:
                LAUNCHES += 1
            src = dst
    return src


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
