"""Fused Fakhari conservative phase-field D2Q9 step on the GPU: wrapper of
``csrc/fakhari_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_fakhari.py``:
:func:`run_fused` of its ``run_fused`` and :func:`step_fused_halo` of its
``step_fused_halo`` (``pallas_fakhari.py:354``), the halo-in entry of the
lattice decomposition.  The lattice is periodic, as there: there is no
geometry argument.  On a CUDA tensor both launch the hand-written kernel
once per step (a collide-and-stream pass, a φ pass and a velocity pass,
plus one φ pass at the start of each call; see the source's header note)
or raise; they never substitute the plain path for a failed build or
launch.  On a CPU tensor, and only there, they run the plain PyTorch
version (:func:`..models.fakhari.run`, and :func:`step_halo_plain`), which
is what the CPU tests exercise.

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
from ..utils.profiling import count_launches, span
from . import _halo

FAMILY = "fakhari_step"
# kernel launches a step (collide-and-stream, φ, velocity), and the φ pass
# that opens each call
LAUNCHES_PER_STEP = 3
LAUNCHES_PER_CALL = 1
# rows of validity one step consumes: the collision reads ∇φ, ∇²φ and the
# stress two rows away, the streaming one more, and the velocity update
# after it ∇φ of the streamed φ two more (pallas_fakhari.py:63)
REACH = 5
# bytes and operations of one float32 step a cell (each input read once,
# each output written once): h, g (2 × 9) and u (2) read and written, about
# 750 operations (the fields, the stress and the force formed twice: before
# the collision and after the streaming)
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


def check_state(h, g, u):
    """Raise unless ``h`` and ``g`` are ``(9, ny, nx)`` and ``u`` is
    ``(2, ny, nx)``, all contiguous, of one float32/float64 dtype, on one
    device."""
    for name, t, q in (("h", h, 9), ("g", g, 9), ("u", u, 2)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} must be float32 or float64, got {t.dtype}")
        if t.ndim != 3 or t.shape[0] != q:
            raise ValueError(f"{name} must have shape ({q}, ny, nx), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("g", g), ("u", u)):
        if (t.shape[1:] != h.shape[1:] or t.dtype != h.dtype
                or t.device != h.device):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} "
                             f"does not match h {tuple(h.shape)} {h.dtype} on "
                             f"{h.device}")


def run_fused(h, g, u, p: FakhariParams, n_steps: int):
    """Advance ``n_steps`` Fakhari steps on the periodic lattice; returns a
    new ``(h, g, u)``.  The caller's tensors are never written."""
    check_state(h, g, u)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if h.device.type == "cpu":
        return fk.run((h, g, u), p, n_steps)
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    if n_steps == 0:
        return h.clone(), g.clone(), u.clone()
    return _launch(h, g, u, p, n_steps, halo_route=False)


def _launch(h, g, u, p: FakhariParams, n_steps: int, halo_route: bool):
    """``n_steps`` kernel steps on the CUDA tensors ``(h, g, u)``,
    ping-ponging two new sets of buffers; counts them (``.halo`` for the
    halo route)."""
    from . import _build

    with span("kernel.prepare", family=FAMILY, steps=n_steps):
        lib = _build.load()
        step = (lib.fakhari_step_f32 if h.dtype == torch.float32
                else lib.fakhari_step_f64)
        consts = kernel_constants(p)
        _, ny, nx = h.shape
        bufs = tuple(tuple(torch.empty_like(t) for t in (h, g, u))
                     for _ in range(2))
        phi = torch.empty((ny, nx), dtype=h.dtype, device=h.device)
    src = (h, g, u)
    with span("kernel.enqueue", family=FAMILY, steps=n_steps):
        # the library's runtime launches into the context current on this
        # thread: make it the tensor's device
        with torch.cuda.device(h.device):
            stream = torch.cuda.current_stream(h.device).cuda_stream
            for i in range(n_steps):
                dst = bufs[i % 2]
                # after the first step, phi already holds Σh of src
                err = step(*(t.data_ptr() for t in src + dst), phi.data_ptr(),
                           ny, nx, int(i > 0), ctypes.addressof(consts), stream)
                if err != 0:
                    raise RuntimeError("fakhari_step launch failed: "
                                       + lib.sc_error_string(err).decode())
                src = dst
    count_launches(FAMILY, n_steps,
                   n_steps * LAUNCHES_PER_STEP + LAUNCHES_PER_CALL, halo_route)
    return src


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
    check_state(h_ext, g_ext, u_ext)
    halo = _halo.check(halo, REACH, nsub, h_ext.shape[1], "rows")
    if h_ext.device.type == "cpu":
        return step_halo_plain(h_ext, g_ext, u_ext, p, nsub, halo)
    if h_ext.device.type != "cuda":
        raise ValueError(f"no kernel for device {h_ext.device}")
    out = _launch(h_ext, g_ext, u_ext, p, nsub, halo_route=True)
    return tuple(_halo.interior(t, halo, 1) for t in out)
