"""Fused Shan–Chen Rayleigh–Taylor D2Q9 step on the GPU: wrapper of
``csrc/scrt_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_scrt.py:run_fused``.  The
channel is implied, as there: rows 0 and ny − 1 are walls, x is periodic.
On a CUDA tensor :func:`run_fused` launches the hand-written kernel once per
step (a ψ pass and a collide-and-stream pass; see the source's header note)
or raises; it never substitutes the plain path for a failed build or
launch.  On a CPU tensor, and only there, it runs the plain PyTorch version
(:func:`..models.shan_chen_rt.run` on the channel geometry), which is what
the CPU tests exercise.  The lattice keeps the model's ``(9, ny, nx)``
layout and its input's dtype (the Pallas path transposes, pads and casts to
float32).

``LAUNCHES`` counts kernel steps launched by this process (one per step), so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..models import shan_chen_rt as rt
from ..models.shan_chen_rt import SCRTParams

LAUNCHES = 0


class _SCRTConst(ctypes.Structure):
    """Mirror of ``struct SCRTConst`` in ``csrc/scrt_step.cu`` (same order)."""
    _fields_ = [(name, ctypes.c_double) for name in (
        "omega", "one_minus_omega", "neg_g", "gravity", "src_fac")]


def kernel_constants(p: SCRTParams) -> _SCRTConst:
    """Host-side constants of one parameter set, in float64 (the kernel
    rounds them to its working type, as JAX rounds Python floats)."""
    return _SCRTConst(omega=p.omega, one_minus_omega=1.0 - p.omega,
                      neg_g=-p.g, gravity=p.gravity,
                      src_fac=1.0 - 0.5 * p.omega)


def check_state(f):
    """Raise unless ``f`` is a contiguous float32/float64 tensor of shape
    ``(9, ny, nx)`` with ``ny >= 3`` (two wall rows and a fluid row)."""
    if not isinstance(f, torch.Tensor):
        raise TypeError("f must be a torch tensor")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"f must be float32 or float64, got {f.dtype}")
    if f.ndim != 3 or f.shape[0] != 9:
        raise ValueError(f"f must have shape (9, ny, nx), got {tuple(f.shape)}")
    if f.shape[1] < 3:
        raise ValueError(f"the channel needs ny >= 3 rows, got {f.shape[1]}")
    if not f.is_contiguous():
        raise ValueError("f must be contiguous")


def run_fused(f, p: SCRTParams, n_steps: int):
    """Advance ``n_steps`` SC-RT steps on the channel; returns a new ``f``
    (``(9, ny, nx)``, the input's dtype, wall rows zero).  The caller's
    tensor is never written."""
    global LAUNCHES
    check_state(f)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    _, ny, nx = f.shape
    if f.device.type == "cpu":
        return rt.run(f, rt.geometry_channel(nx, ny, device=f.device), p,
                      n_steps)
    if f.device.type != "cuda":
        raise ValueError(f"no kernel for device {f.device}")
    if n_steps == 0:
        return f.clone()

    from . import _build

    lib = _build.load()
    step = lib.scrt_step_f32 if f.dtype == torch.float32 else lib.scrt_step_f64
    consts = kernel_constants(p)
    bufs = (torch.empty_like(f), torch.empty_like(f))
    psi = torch.empty((ny, nx), dtype=f.dtype, device=f.device)
    src = f
    # the library's runtime launches into the context current on this
    # thread: make it the tensor's device
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        for i in range(n_steps):
            dst = bufs[i % 2]
            err = step(src.data_ptr(), dst.data_ptr(), psi.data_ptr(), ny, nx,
                       ctypes.addressof(consts), stream)
            if err != 0:
                raise RuntimeError("scrt_step launch failed: "
                                   + lib.sc_error_string(err).decode())
            LAUNCHES += 1
            src = dst
    return src
