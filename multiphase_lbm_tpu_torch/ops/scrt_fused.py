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

:func:`record` is the driver's energy, mass and spike/bubble record of a
state (:func:`..models.shan_chen_rt.kinetic_energy`, Σρ over the fluid and
:func:`..models.shan_chen_rt.interface_height`) from the same source's
record kernel, B4's ψ pass and one record pass that leave four numbers on
the card; it counts as the family ``scrt_record`` (one step and two
launches a record).
"""
from __future__ import annotations

import ctypes

import torch

from ..models import shan_chen_rt as rt
from ..models.shan_chen_rt import SCRTParams
from ..utils.profiling import span
from . import _build, _halo
from ._checks import check_mask, check_tensors, on_card

FAMILY = "scrt_step"
RECORD_FAMILY = "scrt_record"
# kernel launches a step: the ψ pass and the collide-and-stream pass
LAUNCHES_PER_STEP = 2
# columns of validity one step consumes: the force reads ψ one column away
# and the pull streaming one column more
REACH = 2
# bytes and operations of one float32 step a cell (each input read once,
# each output written once): 9 populations read and written (the walls
# follow from the row index), about 300 operations
WORK_PER_CELL = (72, 300)
# kernel launches a record: the ψ pass and the record pass
RECORD_LAUNCHES = 2
# the record pass's largest grid (RECORD_BLOCKS in csrc/scrt_step.cu)
RECORD_BLOCKS = 2048


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
    check_tensors(("f", f, (9, None, None)))
    if f.shape[1] < 3:
        raise ValueError(f"the channel needs ny >= 3 rows, got {f.shape[1]}")


def run_fused(f, p: SCRTParams, n_steps: int):
    """Advance ``n_steps`` SC-RT steps on the channel; returns a new ``f``
    (``(9, ny, nx)``, the input's dtype, wall rows zero).  The caller's
    tensor is never written."""
    check_state(f)
    _, ny, nx = f.shape
    if not on_card(f, n_steps):
        return rt.run(f, rt.geometry_channel(nx, ny, device=f.device), p,
                      n_steps)
    if n_steps == 0:
        return f.clone()
    return _launch(f, p, n_steps, halo_route=False)


def _launch(f, p: SCRTParams, n_steps: int, halo_route: bool):
    """``n_steps`` kernel steps on the CUDA tensor ``f``, ping-ponging two
    new buffers; counts them (``.halo`` for the halo route)."""
    with span("kernel.prepare", family=FAMILY, steps=n_steps):
        consts = kernel_constants(p)
        _, ny, nx = f.shape
        bufs = (torch.empty_like(f), torch.empty_like(f))
        psi = torch.empty((ny, nx), dtype=f.dtype, device=f.device)

    def calls():
        src = f
        for i in range(n_steps):
            dst = bufs[i % 2]
            yield (src.data_ptr(), dst.data_ptr(), psi.data_ptr(), ny, nx,
                   ctypes.addressof(consts))
            src = dst

    _build.enqueue(FAMILY, "scrt_step", f, n_steps,
                   n_steps * LAUNCHES_PER_STEP, calls(), halo_route)
    return bufs[(n_steps - 1) % 2]


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
    if not on_card(f_ext):
        return step_halo_plain(f_ext, p, nsub, halo)
    return _halo.interior(_launch(f_ext, p, nsub, halo_route=True), halo, 2)


def record(f, fluid, p: SCRTParams):
    """The record of the channel state ``f``: a float64 tensor
    ``[E, M, spike, bubble]`` on its device.

    ``E`` is :func:`..models.shan_chen_rt.kinetic_energy` (½ Σ|u + F/(2ρ)|²
    over the fluid over ``fluid.numel()``), ``M`` the sum of ρ over the
    fluid, and ``spike, bubble`` are
    :func:`..models.shan_chen_rt.interface_height`: the largest y in
    [1, ny − 2] with ρ ≤ (ρ_l + ρ_g)/2 at x = nx/2 and at x = 0, or 0.
    ``fluid`` is the channel's ``(ny, nx)`` bool mask
    (:func:`..models.shan_chen_rt.geometry_channel`); the kernel, like the
    step, takes the walls from the row index.  On a CUDA tensor one C call
    of two launches (its sums in double, in a fixed order), or raise; on a
    CPU tensor, and only there, the plain functions' values.  Nothing is
    read to the host here.
    """
    check_state(f)
    check_mask(fluid, f, "fluid", dtype=torch.bool)
    _, ny, nx = f.shape
    if not on_card(f):
        rho = rt.density(f)
        e = float(rt.kinetic_energy(f, fluid, p))
        m = float((rho * fluid).sum())
        rows = rt.interface_height(rho.numpy(), fluid.numpy(), p)
        return torch.tensor([e, m, *rows], dtype=torch.float64)
    with span("kernel.prepare", family=RECORD_FAMILY, steps=1):
        consts = kernel_constants(p)
        psi = torch.empty((ny, nx), dtype=f.dtype, device=f.device)
        ws = torch.empty(3 * RECORD_BLOCKS + 1, dtype=torch.float64,
                         device=f.device)
        out = torch.empty(4, dtype=torch.float64, device=f.device)
    _build.enqueue(RECORD_FAMILY, "scrt_record", f, 1, RECORD_LAUNCHES,
                   [(f.data_ptr(), psi.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), ny, nx, ctypes.addressof(consts),
                     0.5 * (p.rhol + p.rhog))])
    return out
