"""Fused HCZ phase-field D3Q19 step on the GPU: wrapper of
``csrc/hcz3d_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_hcz3d.py``:
:func:`run_fused_3d` of its ``run_fused_3d`` (fully periodic box, no mask)
and :func:`step_fused_halo_3d` of its ``step_fused_halo_3d``
(``pallas_hcz3d.py:299``), the halo-in entry of the z-slab decomposition.
On a CUDA tensor both launch the hand-written kernel once per step (φ,
∇²φ, u-and-P and collide-and-stream passes; see the source's header note)
or raise; they never substitute the plain path for a failed build or
launch.  On a CPU tensor, and only there, they run the plain PyTorch
version (:func:`..models.hcz.run` with ``three_d=True``, and
:func:`step_halo_plain_3d`).

``LAUNCHES`` counts kernel steps launched by :func:`run_fused_3d` in this
process (one per step), and ``HALO_LAUNCHES`` those launched by
:func:`step_fused_halo_3d`.
"""
from __future__ import annotations

import ctypes

import torch

from ..models import hcz
from ..models.hcz import HCZParams
from . import _halo
from .hcz_fused import check_state, kernel_constants

LAUNCHES = 0
HALO_LAUNCHES = 0
# z-planes of validity one step consumes: ∇(∇²φ) two and the pull streaming
# one (pallas_hcz3d.py:27)
REACH = 3


def run_fused_3d(f, g, p: HCZParams, n_steps: int):
    """Advance ``n_steps`` periodic HCZ 3D steps; returns a new ``(f, g)``.

    Args:
      f, g: populations ``(19, nz, ny, nx)``, float32 or float64, contiguous.
    The caller's tensors are never written.
    """
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
    return _launch(f, g, p, n_steps, halo_route=False)


def _launch(f, g, p: HCZParams, n_steps: int, halo_route: bool):
    """``n_steps`` kernel steps on the CUDA tensors ``(f, g)``, ping-ponging
    two new pairs of buffers; counts each in ``HALO_LAUNCHES`` or
    ``LAUNCHES``."""
    global LAUNCHES, HALO_LAUNCHES
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
            if halo_route:
                HALO_LAUNCHES += 1
            else:
                LAUNCHES += 1
            src = dst
    return src


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

    ``halo`` z-planes on each side, ``REACH · nsub`` by default (the
    Pallas entry's fixed width, ``pallas_hcz3d.py:307``); a wider halo
    gives the same interior.  The kernel wraps its z index at the slab's
    ends; those planes reach at most ``REACH · nsub`` planes in, all of
    them cropped.
    """
    check_state(f_ext, g_ext, 3, 19)
    halo = _halo.check(halo, REACH, nsub, f_ext.shape[1], "z-planes")
    if f_ext.device.type == "cpu":
        return step_halo_plain_3d(f_ext, g_ext, p, nsub, halo)
    if f_ext.device.type != "cuda":
        raise ValueError(f"no kernel for device {f_ext.device}")
    out = _launch(f_ext, g_ext, p, nsub, halo_route=True)
    return tuple(_halo.interior(t, halo, 1) for t in out)
