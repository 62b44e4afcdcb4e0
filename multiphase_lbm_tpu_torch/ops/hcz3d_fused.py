"""Fused HCZ phase-field D3Q19 step on the GPU: wrapper of
``csrc/hcz3d_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_hcz3d.py:run_fused_3d``
(fully periodic box, no mask).  On a CUDA tensor :func:`run_fused_3d`
launches the hand-written kernel once per step (φ, ∇²φ, u-and-P and
collide-and-stream passes; see the source's header note) or raises; it
never substitutes the plain path for a failed build or launch.  On a CPU
tensor, and only there, it runs the plain PyTorch version
(:func:`..models.hcz.run` with ``three_d=True``).

``LAUNCHES`` counts kernel steps launched by this process (one per step).
"""
from __future__ import annotations

import ctypes

import torch

from ..models import hcz
from ..models.hcz import HCZParams
from .hcz_fused import check_state, kernel_constants

LAUNCHES = 0


def run_fused_3d(f, g, p: HCZParams, n_steps: int):
    """Advance ``n_steps`` periodic HCZ 3D steps; returns a new ``(f, g)``.

    Args:
      f, g: populations ``(19, nz, ny, nx)``, float32 or float64, contiguous.
    The caller's tensors are never written.
    """
    global LAUNCHES
    check_state(f, g, 3, 19)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if f.device.type == "cpu":
        fluid = torch.ones(f.shape[1:], dtype=torch.bool)
        return hcz.run((f, g), fluid, p, n_steps, lattice=hcz.D3Q19,
                       three_d=True)
    if f.device.type != "cuda":
        raise ValueError(f"no kernel for device {f.device}")
    if n_steps == 0:
        return f.clone(), g.clone()

    from . import _build

    lib = _build.load()
    step = lib.hcz3d_step_f32 if f.dtype == torch.float32 else lib.hcz3d_step_f64
    consts = kernel_constants(p)
    _, nz, ny, nx = f.shape
    bufs = ((torch.empty_like(f), torch.empty_like(g)),
            (torch.empty_like(f), torch.empty_like(g)))
    phi, lap, P = (torch.empty(f.shape[1:], dtype=f.dtype, device=f.device)
                   for _ in range(3))
    src = (f, g)
    # the library's runtime launches into the context current on this
    # thread: make it the tensor's device
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        for i in range(n_steps):
            dst = bufs[i % 2]
            err = step(src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
                       dst[1].data_ptr(), phi.data_ptr(), lap.data_ptr(),
                       P.data_ptr(), nz, ny, nx, ctypes.addressof(consts),
                       stream)
            if err != 0:
                raise RuntimeError("hcz3d_step launch failed: "
                                   + lib.sc_error_string(err).decode())
            LAUNCHES += 1
            src = dst
    return src
