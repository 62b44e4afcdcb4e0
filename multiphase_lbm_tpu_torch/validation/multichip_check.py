"""Checks of the decomposed fused steps against the single-lattice run.

The counterpart of ``multiphase_lbm_tpu/validation/multichip_check.py``.
Each check builds a mesh of shards (four by default: a ring on one axis, or
2 × 2 for the 2D paths), drives the fused decomposed step
(``parallel/sharding.make_fused_*_step``, through the kernel wrappers'
halo-in entries) and the single-lattice run of the same wrapper
(``run_fused``) for the same number of steps from the same state on the
same device, and compares the two states.  Both run the same per-cell
arithmetic (the kernel on a card, the plain path on the CPU), so the
difference is expected to be 0; the gate is ``ATOL``.

Default sizes and ``nsub`` are those of the JAX checks (64 × 32 rows a
shard, 16 × 16 × 8 planes a shard in 3D, the 128 × 64 combustion channel
on 4 y shards from a warm reacting state); ``sc`` is this package's own
addition, the 1D cut of the SC lattice, and so is ``combustion_narrow``,
the 128 × 20 channel on 4 shards of 5 rows at nsub 1 (exchange 4 rows),
whose cuts fall within the exchange width of both wall rows and through
the obstacles (one size only: ``--full`` runs the same).  ``--full`` runs
the full-width case of each path (``FULL``).  Combustion is compared over
the cells where the model defines each field
(``models.combustion.defined_values``: the forcing terms hold NaN at solid
cells by design); every check also reports whether the two states are
bit-identical, NaN positions included.  On a card, ``timing=True`` also
times the
decomposed step, its exchange and its local compute, and the
single-lattice run, with CUDA events; shards on one card run one after
another, so these times measure the decomposition's overhead, not scaling.

    python -m multiphase_lbm_tpu_torch.validation.multichip_check NAME
        [--device cuda|cpu] [--full] [--n-devices N] [--nsub N]
        [--profile CALLS]

NAME is one of ``hcz_wide``, ``hcz2d``, ``hcz3d``, ``fakhari``, ``scrt``,
``sc``, ``sc2d``, ``combustion`` and ``combustion_narrow``.  The default
device is the card; ``--device cpu`` runs the plain path (the CPU tests).  With
``--profile CALLS`` on a card it also prints one JSON line: the device time
by kernel, the device's busy time and its idle share over CALLS calls of the
decomposed step, and over as many steps of the single-lattice run, under
``torch.profiler`` (``utils/profiling.device_profile``).  Exits 0 when the
check holds.  There is no counterpart of the JAX module's
``_force_cpu``: the mesh takes its devices as an argument.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Callable

import numpy as np
import torch

from ..models import combustion as cbm
from ..models import fakhari as fk
from ..models import hcz
from ..models import shan_chen as sc
from ..models import shan_chen_rt as rt
from ..ops import (_halo, combustion_fused, fakhari_fused, hcz3d_fused,
                   hcz_fused, sc_fused, scrt_fused)
from ..parallel import sharding as sh
from ..utils.profiling import device_profile

ATOL = 1e-6

# full-width cases: mesh size, nsub and steps (HCZ on 2 shards: the
# RTI-2048 channel's 8194 rows do not divide by 4)
FULL = {"hcz_wide": dict(n_devices=2, nsub=5, steps=100),
        "hcz2d": dict(n_devices=4, nsub=2, steps=40),
        "sc": dict(n_devices=4, nsub=4, steps=100),
        "sc2d": dict(n_devices=4, nsub=2, steps=40),
        "fakhari": dict(n_devices=4, nsub=2, steps=100),
        "scrt": dict(n_devices=4, nsub=2, steps=100),
        "hcz3d": dict(n_devices=4, nsub=2, steps=50),
        "combustion": dict(n_devices=4, nsub=2, steps=100),
        "combustion_narrow": dict(n_devices=4, nsub=1, steps=4)}
# the JAX checks' defaults: mesh size, nsub and steps
DEFAULT = {"hcz_wide": dict(n_devices=4, nsub=5, steps=5),
           "hcz2d": dict(n_devices=4, nsub=2, steps=4),
           "sc": dict(n_devices=4, nsub=2, steps=4),
           "sc2d": dict(n_devices=4, nsub=2, steps=4),
           "fakhari": dict(n_devices=4, nsub=2, steps=2),
           "scrt": dict(n_devices=4, nsub=2, steps=4),
           "hcz3d": dict(n_devices=4, nsub=2, steps=2),
           "combustion": dict(n_devices=4, nsub=2, steps=4),
           "combustion_narrow": dict(n_devices=4, nsub=1, steps=4)}


@dataclasses.dataclass
class Case:
    """One decomposed path set up for a check: ``state`` (global tensors)
    and ``static`` (global tensors read but not advanced, such as the fluid
    mask) are cut over ``mesh`` with ``leading`` axes each; ``step`` is the
    decomposed step; ``single(state, n)`` the single-lattice run;
    ``halo_plain(mesh position, *extended blocks)`` the plain version of the
    step's local half on one shard's extended blocks (the halo entry's plain
    version, and on a 2D mesh the x crop); ``defined(state, idx=None)`` the
    tensors of a global state, or of the block of it at mesh position
    ``idx``, that a comparison holds (default: all of it); ``work``, where
    the work of a cell depends on the data, maps a region (one array of
    global indices for each spatial axis) to the (bytes, operations) of one
    step over it (default: the cells times the family's
    ``WORK_PER_CELL``)."""
    label: str
    family: str              # the halo entry's family (HALO_ENTRIES)
    mesh: sh.Mesh
    step: sh.HaloStep
    state: tuple
    leading: tuple
    static: tuple
    static_leading: tuple
    single: Callable
    nsub: int
    halo_plain: Callable
    defined: Callable = lambda state, idx=None: tuple(state)
    work: Callable = None


def _mesh(n, device, two_d=False, axis="y"):
    shape, names = ((2, n // 2), ("y", "x")) if two_d else ((n,), (axis,))
    return sh.make_mesh(n, shape=shape, axis_names=names,
                        devices=[torch.device(device)])


def _x_crop(two_d, H):
    """The crop a 2D path makes of the x halo after the halo entry, as a
    function of the entry's output (identity on a 1D mesh)."""
    def crop(out):
        out = out if isinstance(out, tuple) else (out,)
        return tuple(_halo.interior(t, H, t.ndim - 1) if two_d else t
                     for t in out)
    return crop


def _case_hcz(device, full, n, nsub, dtype, two_d):
    from .rti_regression import rti_state

    if full:
        p, st, fluid = rti_state(2048, device, dtype)
    else:
        p = hcz.HCZParams(omega=1.25)
        nx, ny = (64, 64) if two_d else (64, 32 * n)
        fluid = hcz.geometry_channel(nx, ny, device=device)
        st = hcz.apply_geometry(
            hcz.init_rayleigh_taylor(nx, ny, p, dtype=dtype, device=device),
            fluid)
    mesh = _mesh(n, device, two_d)
    make = sh.make_fused_hcz_step_2d if two_d else sh.make_fused_hcz_step
    m32 = fluid.to(torch.float32)
    crop = _x_crop(two_d, hcz_fused.REACH * nsub)
    return Case(
        f"HCZ {st[0].shape[2]}x{st[0].shape[1]}", "hcz", mesh,
        make(mesh, p, nsub=nsub), st, (1, 1), (m32,), (0,),
        lambda s, k: hcz_fused.run_fused(*s, m32, p, k), nsub,
        lambda _, *e: crop(hcz_fused.step_halo_plain(*e, p, nsub)))


def _case_sc(device, full, n, nsub, dtype, two_d):
    p = sc.SCParams(collision="mrt", omega=1.25)
    nx, ny = (2048, 2048) if full else (64, 32)
    f = sc.init_droplet(nx, ny, p, radius=nx / 8.0 if full else 6.0,
                        dtype=dtype, device=device)
    fluid = sc.geometry_channel_walls(nx, ny, device=device)
    f = sc.apply_geometry(f, fluid)
    m32 = fluid.to(torch.float32)
    mesh = _mesh(n, device, two_d)
    make = sh.make_fused_sc_step_2d if two_d else sh.make_fused_sc_step
    crop = _x_crop(two_d, sc_fused.REACH * nsub)
    return Case(f"SC MRT omega=1.25 walled {nx}x{ny}", "sc", mesh,
                make(mesh, p, nsub=nsub), (f,), (1,), (m32,), (0,),
                lambda s, k: (sc_fused.run_fused(s[0], m32, p, k),), nsub,
                lambda _, *e: crop(sc_fused.step_halo_plain(*e, p, nsub)))


def _case_hcz3d(device, full, n, nsub, dtype, two_d):
    if full:
        from ..bench import hcz3d_params

        p, (nx, ny, nz), radius = hcz3d_params(), (128, 128, 128), None
    else:
        p = hcz.HCZParams(omega=1.2, gravity=0.0, kappa=0.01)
        nx, ny, nz, radius = 16, 16, 8 * n, 5.0
    st = hcz.init_droplet_3d(nx, ny, nz, p, radius=radius, dtype=dtype,
                             device=device)
    mesh = _mesh(n, device, axis="z")
    return Case(f"HCZ 3D droplet {nx}x{ny}x{nz}", "hcz3d", mesh,
                sh.make_fused_hcz3d_step(mesh, p, nsub=nsub), st, (1, 1), (),
                (), lambda s, k: hcz3d_fused.run_fused_3d(*s, p, k), nsub,
                lambda _, *e: hcz3d_fused.step_halo_plain_3d(*e, p, nsub))


def _case_fakhari(device, full, n, nsub, dtype, two_d):
    p = fk.FakhariParams()
    nx, ny = (2048, 2048) if full else (64, 32 * n)
    st = fk.init_bubble(nx, ny, p, dtype=dtype, device=device)
    mesh = _mesh(n, device)
    return Case(f"Fakhari bubble {nx}x{ny}", "fakhari", mesh,
                sh.make_fused_fakhari_step(mesh, p, nsub=nsub), st, (1, 1, 1),
                (), (), lambda s, k: fakhari_fused.run_fused(*s, p, k), nsub,
                lambda _, *e: fakhari_fused.step_halo_plain(*e, p, nsub))


def _case_scrt(device, full, n, nsub, dtype, two_d):
    p = rt.SCRTParams() if full else rt.SCRTParams(omega=1.25)
    nx = 2048 if full else 8 * n
    ny = 4 * nx + 2
    f = rt.init_interface(nx, ny, p, dtype=dtype, device=device) \
        * rt.geometry_channel(nx, ny, device=device)[None]
    mesh = _mesh(n, device, axis="x")
    return Case(f"SC-RT channel {nx}x{ny} omega={p.omega}", "scrt", mesh,
                sh.make_fused_scrt_step(mesh, p, nsub=nsub), (f,), (1,), (), (),
                lambda s, k: (scrt_fused.run_fused(s[0], p, k),), nsub,
                lambda _, *e: scrt_fused.step_halo_plain(*e, p, nsub))


def _combustion_defined(arrays, flags) -> tuple:
    """The tensors of ``models.combustion.defined_values`` of the eight
    state arrays ``arrays`` on the cells of ``flags``."""
    return tuple(cbm.defined_values(cbm.CombustionState(*arrays, None),
                                    flags).values())


def combustion_warm_state(p, device, dtype):
    """The JAX check's warm reacting state of ``p``: ``initialize`` with
    ``T_solid = 1.8``, 60 flow-only steps, one first step and 10 steps with
    all four populations, through ``run_fused`` (the kernel on a card)."""
    flags, _ = cbm.build_geometry(p)
    st = cbm.initialize(p, dtype, T_solid=1.8, flags=flags, device=device)
    st = combustion_fused.run_fused(st, p, 60, konv=False)
    st = combustion_fused.run_fused(st, p, 1, first_step=True)
    return combustion_fused.run_fused(st, p, 10)


def _case_combustion(device, full, n, nsub, dtype, narrow):
    if full and not narrow:
        from ..bench import combustion_params, combustion_state

        # 840 × 160 after the bench's 2N warm-up steps
        p = combustion_params(840)
        st = tuple(t.to(dtype) for t in combustion_state(p, device))
    else:
        p = cbm.CombustionParams(nx=128, ny=5 * n if narrow else 16 * n,
                                 Y_O2_ini=0.22)
        st = combustion_warm_state(p, device, dtype)
    flags, _ = cbm.build_geometry(p)
    q0 = st[8]
    mesh = _mesh(n, device)
    H = combustion_fused.REACH * nsub
    ny_loc = p.ny // n

    def defined(s, idx=None):
        return _combustion_defined(s, flags if idx is None else flags[
            idx[0] * ny_loc:(idx[0] + 1) * ny_loc])

    def single(s, k):
        return combustion_fused.run_fused(cbm.CombustionState(*s, q0), p,
                                          k)[:8]

    def halo_plain(idx, *e):
        return combustion_fused.step_halo_plain(e, idx[0] * ny_loc - H, p,
                                                nsub=nsub)

    return Case(f"combustion channel {p.nx}x{p.ny}", "combustion", mesh,
                sh.make_fused_combustion_step(mesh, p, nsub=nsub), st[:8],
                (1,) * 8, (), (), single, nsub, halo_plain, defined,
                lambda region: combustion_fused.step_work(p, True, region[0]))


CASES = {"hcz_wide": (_case_hcz, False), "hcz2d": (_case_hcz, True),
         "sc": (_case_sc, False), "sc2d": (_case_sc, True),
         "hcz3d": (_case_hcz3d, False), "fakhari": (_case_fakhari, False),
         "scrt": (_case_scrt, False),
         "combustion": (_case_combustion, False),
         "combustion_narrow": (_case_combustion, True)}


def make_case(name, device, full=False, n_devices=None, nsub=None,
              dtype=torch.float32) -> tuple:
    """``(Case, steps)`` of check ``name``: the full-width case with
    ``full``, else the JAX check's size."""
    if name not in CASES:
        raise ValueError(f"unknown check {name!r}; one of {sorted(CASES)}")
    cfg = (FULL if full else DEFAULT)[name]
    n = n_devices or cfg["n_devices"]
    k = nsub or cfg["nsub"]
    # the configured number of calls, at the given nsub
    steps = cfg["steps"] // cfg["nsub"] * k
    build, two_d = CASES[name]
    return build(torch.device(device), full, n, k, dtype, two_d), steps


def run_decomposed(case: Case, calls: int) -> tuple:
    """The state after ``calls`` decomposed steps, as global tensors."""
    state, static = _shards(case)
    for _ in range(calls):
        out = case.step(*state, *static)
        state = out if isinstance(out, tuple) else (out,)
    return tuple(t.gather() for t in state)


def _event_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls, by CUDA events,
    after one call to warm up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _shards(case: Case) -> tuple:
    """The case's state and static tensors, each cut over its mesh."""
    return (tuple(sh.shard_lattice(t, case.mesh, lead)
                  for t, lead in zip(case.state, case.leading)),
            tuple(sh.shard_lattice(t, case.mesh, lead)
                  for t, lead in zip(case.static, case.static_leading)))


def _kept_valid(case: Case):
    """The regions the halo entries must advance: for each sub-step j of
    ``nsub`` and each shard, one array of global indices (modulo the
    lattice) for each spatial axis.  After sub-step j only the shard's own
    cells and ``reach · (nsub − j)`` more on each side of every cut axis are
    still read."""
    reach = HALO_ENTRIES[case.family].REACH
    lead = case.leading[0]
    glob = case.state[0].shape[lead:]
    spec = sh.lattice_pspec(case.mesh, len(glob), lead)[lead:]
    for j in range(1, case.nsub + 1):
        r = reach * (case.nsub - j)
        for idx in np.ndindex(case.mesh.shape):
            region = []
            for n, a in zip(glob, spec):
                if a is None:
                    region.append(np.arange(n))
                    continue
                loc = n // case.mesh.axis_size(a)
                i = idx[case.mesh.axis_names.index(a)]
                region.append(np.arange(i * loc - r, (i + 1) * loc + r) % n)
            yield region


def halo_bound_cells(case: Case) -> float:
    """The cells the halo entries must advance a sub-step
    (:func:`_kept_valid`), summed over the shards and averaged over the
    ``nsub`` sub-steps of a call: the least work of the halo route.  The entries advance the whole
    extended slab on every sub-step; the difference is the halo
    recompute."""
    return sum(math.prod(len(a) for a in region)
               for region in _kept_valid(case)) / case.nsub


def halo_bound_work(case: Case) -> tuple:
    """The (bytes, operations) of :func:`halo_bound_cells`'s cells: each
    region priced by ``case.work`` (combustion: ``combustion_fused.step_work``
    of its global rows, by their flags) or, by default, its cells times the
    family's ``WORK_PER_CELL``; summed over the shards and averaged over
    the sub-steps."""
    total = np.zeros(2)
    for region in _kept_valid(case):
        if case.work is not None:
            total += case.work(region)
        else:
            per_cell = HALO_ENTRIES[case.family].WORK_PER_CELL
            total += math.prod(len(a) for a in region) * np.array(per_cell)
    return tuple(float(v) / case.nsub for v in total)


def time_case(case: Case, reps: int = 5, plain: bool = False) -> dict:
    """Milliseconds per lattice step on the card, by CUDA events: the
    decomposed step (``step_ms``), its exchange (``exchange_ms``), its
    compute, the halo entries and crops on every shard (``compute_ms``),
    and the single-lattice run (``single_ms``); the extended slabs' cells
    (``ext_cells``), :func:`halo_bound_cells` (``bound_cells``) and
    :func:`halo_bound_work` (``bound_work``).  With ``plain``, also the
    plain version of the compute half on the same extended blocks
    (``plain_ms``, one timed call) and :func:`against_plain` of the compute
    half's last timed result."""
    state, static = _shards(case)
    state = list(state)
    ext = case.step.exchange(*state, *static)
    computed = []

    def step():
        out = case.step(*state, *static)
        state[:] = out if isinstance(out, tuple) else (out,)

    def compute():
        out = case.step.compute(*ext)
        computed[:] = out if isinstance(out, tuple) else (out,)

    k = case.nsub
    res = {"step_ms": _event_ms(step, reps) / k,
           "exchange_ms": _event_ms(lambda: case.step.exchange(*state, *static),
                                    reps) / k,
           "compute_ms": _event_ms(compute, reps) / k,
           "single_ms": _event_ms(lambda: case.single(case.state, k),
                                  reps) / k,
           "ext_cells": sum(b[0].numel() for b in ext[0].flat),
           "bound_cells": halo_bound_cells(case),
           "bound_work": halo_bound_work(case)}
    if plain:
        plains = np.empty(case.mesh.shape, dtype=object)

        def plain_all():
            for idx in np.ndindex(case.mesh.shape):
                plains[idx] = case.halo_plain(idx, *(e[idx] for e in ext))

        res["plain_ms"] = _event_ms(plain_all, 1) / k
        res.update(against_plain(case, ext, computed, plains))
    res["exchange_share"] = res["exchange_ms"] / res["step_ms"]
    return res


def against_plain(case: Case, ext, outs, plains=None) -> dict:
    """The compute half's result ``outs`` (its :class:`ShardedLattice`
    results) on the extended blocks ``ext`` against the plain version of
    the same half on the same blocks (``plains``, an object array of its
    results in mesh order, computed here when None): ``plain_err``, the
    largest absolute difference over the shards; ``plain_ok``, finite, same
    shapes and within ``plain_tol``, the family's tolerance of
    :func:`check_halo_entry`; both over ``case.defined`` of each shard."""
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    tol = _tolerance(case.family, case.state[0].dtype)
    err, ok = 0.0, True
    for idx in np.ndindex(case.mesh.shape):
        ref = (plains[idx] if plains is not None
               else case.halo_plain(idx, *(e[idx] for e in ext)))
        ref = ref if isinstance(ref, (tuple, list)) else (ref,)
        e, o = _compare(case.defined([t.blocks[idx] for t in outs], idx),
                        case.defined(ref, idx), tol)
        err, ok = max(err, e), ok and o
    return {"plain_err": err, "plain_ok": ok, "plain_tol": tol}


def profile_case(case: Case, calls: int) -> dict:
    """:func:`..utils.profiling.device_profile` of ``calls`` decomposed
    steps and of as many single-lattice steps, from the case's state."""
    state, static = _shards(case)

    def decomposed(st):
        for _ in range(calls):
            out = case.step(*st, *static)
            st = out if isinstance(out, tuple) else (out,)
        return st[0].blocks.flat[0]

    n = calls * case.nsub
    return {"decomposed": device_profile(decomposed, state, n),
            "single": device_profile(lambda s: case.single(s, n), case.state,
                                     n)}


def check(name, device="cuda", full=False, n_devices=None, nsub=None,
          dtype=torch.float32, timing=False, plain=False) -> dict:
    """Run check ``name``: the decomposed path against the single-lattice
    run.  Returns ``max_abs_err`` and ``ok`` (finite and within ``ATOL``)
    over ``case.defined``, ``bit_identical`` (every cell, NaN positions
    included), a description of the case and, with ``timing`` on a card,
    :func:`time_case`'s numbers."""
    case, steps = make_case(name, device, full, n_devices, nsub, dtype)
    if steps % case.nsub:
        raise ValueError(f"{steps} steps are not a whole number of calls of "
                         f"{case.nsub} steps")
    out = run_decomposed(case, steps // case.nsub)
    ref = case.single(case.state, steps)
    identical = all(bool(((o == r) | (o.isnan() & r.isnan())).all())
                    for o, r in zip(out, ref))
    out, ref = case.defined(out), case.defined(ref)
    err = max(float((o.double() - r.double()).abs().max())
              for o, r in zip(out, ref))
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    del out, ref
    res = {"name": name, "label": case.label, "mesh": case.mesh.shape,
           "axes": case.mesh.axis_names, "nsub": case.nsub, "steps": steps,
           "max_abs_err": err, "ok": finite and err <= ATOL,
           "bit_identical": identical, "cells": case.state[0][0].numel()}
    if timing:
        res.update(time_case(case, plain=plain))
    return res


# ─── a halo-in entry against its plain version ────────────────────────────
# the halo-in entries' families and their wrappers
HALO_ENTRIES = {"sc": sc_fused, "hcz": hcz_fused, "fakhari": fakhari_fused,
                "scrt": scrt_fused, "hcz3d": hcz3d_fused,
                "combustion": combustion_fused}
# kernel against plain in float32, by family (the tolerances of the
# families' kernel checks: summation order and FMA contraction differ);
# float64 at atol 1e-12
HALO_F32_TOL = {"sc": dict(rtol=2e-5, atol=2e-6),
                "scrt": dict(rtol=2e-5, atol=2e-6),
                "hcz": dict(rtol=3e-5, atol=3e-6),
                "hcz3d": dict(rtol=5e-5, atol=5e-6),
                "fakhari": dict(rtol=5e-5, atol=5e-6),
                "combustion": dict(rtol=2e-5, atol=2e-6)}
HALO_F64_TOL = dict(rtol=0.0, atol=1e-12)


def _tolerance(family, dtype) -> dict:
    return HALO_F32_TOL[family] if dtype == torch.float32 else HALO_F64_TOL


def _compare(outs, refs, tol) -> tuple:
    """``(max_abs_err, ok)`` of the tensors ``outs`` against ``refs``:
    ``ok`` when the shapes match, every output is finite and contiguous and
    every cell lies within ``atol + rtol · |ref|``."""
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    refs = refs if isinstance(refs, (tuple, list)) else (refs,)
    err, ok = 0.0, len(outs) == len(refs)
    for o, r in zip(outs, refs):
        if o.shape != r.shape:
            return float("inf"), False
        d = (o.double() - r.double()).abs()
        err = max(err, float(d.max()))
        ok = ok and o.is_contiguous() and bool(torch.isfinite(o).all()) \
            and bool((d <= tol["atol"] + tol["rtol"] * r.double().abs()).all())
    return err, ok


def _slab(t, lo, hi, dim):
    """Cells ``lo .. hi − 1`` of ``t`` along ``dim``, wrapping, as a new
    contiguous tensor."""
    idx = torch.arange(lo, hi, device=t.device) % t.shape[dim]
    return t.index_select(dim, idx).contiguous()


def halo_entry_case(family, dtype, nsub, device, variant="konv"):
    """``(wrapper module, halo-in entry, its plain version, args)``: one
    shard's halo-extended slab of a lattice of ``family`` at ω ≠ 1 (64 own
    rows, columns or z-planes and a halo of ``REACH · nsub`` on each side,
    cut from a larger lattice with wrapping).  Combustion: the 128 × 256
    channel with the full flow MRT from :func:`combustion_warm_state`, own
    rows −32 .. 31, so both wall rows and the y wrap lie inside them;
    ``variant`` "konv" (all four populations), "flow" (flow only) or
    "cavity" (the lid cavity, all four: the lid's momentum exchange at the
    global top row)."""
    dev = torch.device(device)
    if family == "sc":
        p = sc.SCParams(collision="mrt", omega=1.25, rho_w=0.2, gravity=1e-5)
        fluid = sc.geometry_channel_walls(128, 128, device=dev)
        fluid[40:48, 100:120] = False                # an obstacle
        f = sc.apply_geometry(sc.init_droplet(
            128, 128, p, radius=32.0, center=(64.0, 5.0), dtype=dtype,
            device=dev), fluid)
        H = sc_fused.REACH * nsub
        args = (_slab(f, -H, 64 + H, 1),
                _slab(fluid.to(torch.float32), -H, 64 + H, 0), p)
        return sc_fused, sc_fused.step_fused_halo, sc_fused.step_halo_plain, args
    if family == "hcz":
        p = hcz.HCZParams(omega=1.25, gravity=-1e-5)
        fluid = hcz.geometry_channel(128, 256, device=dev)
        st = hcz.apply_geometry(hcz.init_rayleigh_taylor(
            128, 256, p, dtype=dtype, device=dev), fluid)
        H = hcz_fused.REACH * nsub
        lo, hi = 96 - H, 160 + H                     # across the interface
        args = (*(_slab(t, lo, hi, 1) for t in st),
                _slab(fluid.to(torch.float32), lo, hi, 0), p)
        return (hcz_fused, hcz_fused.step_fused_halo,
                hcz_fused.step_halo_plain, args)
    if family == "fakhari":
        p = fk.FakhariParams()
        st = fk.init_bubble(128, 128, p, dtype=dtype, device=dev)
        H = fakhari_fused.REACH * nsub
        args = (*(_slab(t, 32 - H, 96 + H, 1) for t in st), p)
        return (fakhari_fused, fakhari_fused.step_fused_halo,
                fakhari_fused.step_halo_plain, args)
    if family == "scrt":
        p = rt.SCRTParams(omega=1.25)
        f = rt.init_interface(128, 258, p, dtype=dtype, device=dev) \
            * rt.geometry_channel(128, 258, device=dev)[None]
        H = scrt_fused.REACH * nsub
        args = (_slab(f, -H, 64 + H, 2), p)
        return (scrt_fused, scrt_fused.step_fused_halo,
                scrt_fused.step_halo_plain, args)
    if family == "hcz3d":
        p = hcz.HCZParams(omega=1.2, kappa=5e-4)
        st = hcz.init_droplet_3d(32, 32, 128, p, radius=12.0, dtype=dtype,
                                 device=dev)
        H = hcz3d_fused.REACH * nsub
        args = (*(_slab(t, 32 - H, 96 + H, 1) for t in st), p)
        return (hcz3d_fused, hcz3d_fused.step_fused_halo_3d,
                hcz3d_fused.step_halo_plain_3d, args)
    if family == "combustion":
        if variant not in ("konv", "flow", "cavity"):
            raise ValueError(f"unknown combustion variant {variant!r}")
        topo = (dict(topology="cavity", u_lid=0.05) if variant == "cavity"
                else {})
        p = cbm.CombustionParams(nx=128, ny=256, Y_O2_ini=0.22, tau_flow=0.8,
                                 w_e=1.1, w_eps=1.2, w_q=1.3, **topo)
        st = combustion_warm_state(p, dev, dtype)
        H = combustion_fused.REACH * nsub
        row0 = -32 - H
        ext = tuple(_slab(t, row0, 32 + H, 1) for t in st[:8])
        tables = combustion_fused.slab_tables(p, row0, ext[0].shape[1], dev,
                                              dtype)
        args = (ext, tables, row0, p, variant != "flow")
        # the plain version reads the geometry from p, not the tables
        return (combustion_fused, combustion_fused.step_fused_halo,
                lambda ext, _, *rest, **kw: combustion_fused.step_halo_plain(
                    ext, *rest, **kw), args)
    raise ValueError(f"unknown family {family!r}; one of {list(HALO_ENTRIES)}")


def check_halo_entry(family, dtype, nsub, device="cuda", variant="konv"
                     ) -> dict:
    """The halo-in entry of ``family`` against its plain version on one
    extended slab (:func:`halo_entry_case`, of ``variant``): ``max_abs_err``,
    ``ok``
    (finite, same shapes, within the family's tolerance), ``launched``,
    the entry's ``HALO_LAUNCHES`` increase, and ``launched_main``, the
    wrapper's ``LAUNCHES`` increase (0: the halo route counts apart)."""
    mod, kernel, plain, args = halo_entry_case(family, dtype, nsub, device,
                                               variant)
    before, before_main = mod.HALO_LAUNCHES, mod.LAUNCHES
    out = kernel(*args, nsub=nsub)
    launched = mod.HALO_LAUNCHES - before
    launched_main = mod.LAUNCHES - before_main
    tol = _tolerance(family, dtype)
    ref = plain(*args, nsub=nsub)
    if family == "combustion":
        # over the cells where the model defines each field (the forcing
        # terms are NaN at solid cells), from the slab's interior flags
        flags = _halo.interior(args[1]["flags"], mod.REACH * nsub, 0)
        out, ref = (_combustion_defined(t, flags.cpu().numpy())
                    for t in (out, ref))
    err, ok = _compare(out, ref, tol)
    return {"max_abs_err": err, "ok": ok, "launched": launched,
            "launched_main": launched_main, "tol": tol}


def summary(res: dict) -> str:
    mesh = " x ".join(f"{n} {a}" for n, a in zip(res["mesh"], res["axes"]))
    return (f"{res['name']}: {res['label']}, mesh {mesh}, nsub {res['nsub']}, "
            f"{res['steps']} steps: max |diff| against the single-lattice "
            f"run {res['max_abs_err']:.3e} (<= {ATOL:g}), "
            f"{'bit-identical' if res['bit_identical'] else 'not bit-identical'}"
            f" {'OK' if res['ok'] else 'FAIL'}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="multichip_check",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("name", choices=sorted(CASES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the full-width case instead of the JAX check's size")
    ap.add_argument("--n-devices", type=int, default=None)
    ap.add_argument("--nsub", type=int, default=None)
    ap.add_argument("--profile", type=int, default=0, metavar="CALLS",
                    help="also profile CALLS decomposed calls on the card")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("multichip_check: no CUDA device visible; --device cpu runs the "
              "plain path", file=sys.stderr)
        return 2
    res = check(args.name, args.device, args.full, args.n_devices, args.nsub)
    print(summary(res))
    if args.profile:
        case, _ = make_case(args.name, args.device, args.full, args.n_devices,
                            args.nsub)
        print(json.dumps({"check": args.name, "label": case.label,
                          **profile_case(case, args.profile)}))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
