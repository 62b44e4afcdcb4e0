"""Fused Shan–Chen Rayleigh–Taylor D2Q9 step on the GPU: wrapper of
``csrc/scrt_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_scrt.py``:
:func:`run_fused` of its ``run_fused`` and :func:`step_fused_halo` of its
``step_fused_halo`` (``pallas_scrt.py:277``), the halo-in entry of the
lattice decomposition.  The channel is implied, as there: rows 0 and
ny − 1 are walls, x is periodic.  On a CUDA tensor both launch the
hand-written kernel once per step (a ψ pass and a collide-and-stream pass;
see the source's header note) or raise; they never substitute the plain
path for a failed build or launch.  On a CPU tensor, and only there, they
run the plain PyTorch version (:func:`..models.shan_chen_rt.run` on the
channel geometry, and :func:`step_halo_plain`), which is what the CPU tests
exercise.  The lattice keeps the model's ``(9, ny, nx)`` layout and its
input's dtype (the Pallas path transposes, pads and casts to float32), so
the halo entry cuts x, the last axis, and keeps the walled y whole.

Each call counts its steps and launches in the recorder of
:mod:`..utils.profiling` (``kernel.steps.scrt_step``,
``kernel.launches.scrt_step``; ``.halo`` after them for
:func:`step_fused_halo`), so a run can show that its main path went through
the kernel, and records the ``kernel.prepare`` and ``kernel.enqueue`` spans.
"""
from __future__ import annotations

import ctypes

import torch

from ..models import shan_chen_rt as rt
from ..models.shan_chen_rt import SCRTParams
from ..utils.profiling import count_launches, span
from . import _halo

FAMILY = "scrt_step"
# kernel launches a step: the ψ pass and the collide-and-stream pass
LAUNCHES_PER_STEP = 2
# columns of validity one step consumes: the force reads ψ one column away
# and the pull streaming one column more
REACH = 2
# bytes and operations of one float32 step a cell (each input read once,
# each output written once): 9 populations read and written (the walls
# follow from the row index), about 300 operations
WORK_PER_CELL = (72, 300)


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
    return _launch(f, p, n_steps, halo_route=False)


def _launch(f, p: SCRTParams, n_steps: int, halo_route: bool):
    """``n_steps`` kernel steps on the CUDA tensor ``f``, ping-ponging two
    new buffers; counts them (``.halo`` for the halo route)."""
    from . import _build

    with span("kernel.prepare", family=FAMILY, steps=n_steps):
        lib = _build.load()
        step = (lib.scrt_step_f32 if f.dtype == torch.float32
                else lib.scrt_step_f64)
        consts = kernel_constants(p)
        _, ny, nx = f.shape
        bufs = (torch.empty_like(f), torch.empty_like(f))
        psi = torch.empty((ny, nx), dtype=f.dtype, device=f.device)
    src = f
    with span("kernel.enqueue", family=FAMILY, steps=n_steps):
        # the library's runtime launches into the context current on this
        # thread: make it the tensor's device
        with torch.cuda.device(f.device):
            stream = torch.cuda.current_stream(f.device).cuda_stream
            for i in range(n_steps):
                dst = bufs[i % 2]
                err = step(src.data_ptr(), dst.data_ptr(), psi.data_ptr(), ny,
                           nx, ctypes.addressof(consts), stream)
                if err != 0:
                    raise RuntimeError("scrt_step launch failed: "
                                       + lib.sc_error_string(err).decode())
                src = dst
    count_launches(FAMILY, n_steps, n_steps * LAUNCHES_PER_STEP, halo_route)
    return src


def step_halo_plain(f_ext, p: SCRTParams, nsub: int = 1, halo=None):
    """The plain version of :func:`step_fused_halo`, on any device:
    ``nsub`` plain steps of the whole slab, then its interior columns."""
    _, ny, nx_ext = f_ext.shape
    halo = _halo.check(halo, REACH, nsub, nx_ext, "columns")
    out = rt.run(f_ext, rt.geometry_channel(nx_ext, ny, device=f_ext.device),
                 p, nsub)
    return _halo.interior(out, halo, 2)


def step_fused_halo(f_ext, p: SCRTParams, nsub: int = 1, halo=None):
    """``nsub`` SC-RT steps on a channel slab whose halo columns are
    already filled; returns the interior ``(9, ny, nx_ext − 2·halo)``.

    ``f_ext`` is ``(9, ny, nx_loc + 2·halo)``: the periodic x axis is cut
    and the walled y axis is whole, as the Pallas path's transposed
    ``(9, nx, ny_pad)`` slab holds it.  ``halo`` columns on each side, at
    least ``REACH · nsub`` (the default); a wider halo gives the same
    interior.  The kernel wraps its column index at the slab's edges; those
    columns reach at most ``REACH · nsub`` columns in, all of them cropped.
    """
    check_state(f_ext)
    halo = _halo.check(halo, REACH, nsub, f_ext.shape[2], "columns")
    if f_ext.device.type == "cpu":
        return step_halo_plain(f_ext, p, nsub, halo)
    if f_ext.device.type != "cuda":
        raise ValueError(f"no kernel for device {f_ext.device}")
    return _halo.interior(_launch(f_ext, p, nsub, halo_route=True), halo, 2)
