"""Reactive MRT combustion step on the GPU: wrapper of
``csrc/combustion_step.cu``.

The counterpart of ``multiphase_lbm_tpu/ops/pallas_combustion.py:
run_fused``.  On a CUDA tensor :func:`run_fused` launches the hand-written
kernel (three launches a step with all four populations in the
inflow/outflow channel, two elsewhere, one for the flow alone; see the
source's header note) or raises; it never
substitutes the plain path for a failed build or launch.  On a CPU tensor,
and only there, it runs the plain PyTorch version (:func:`..models.combustion
.run`), which is what the CPU tests exercise.  The state keeps its dtype
(float32 or float64; the Pallas path is float32 only), and the caller's
tensors are never written.

:func:`check_params` refuses what the Pallas kernel's ``_check_supported``
refuses: the GUO2015 and HUBER2015 schemes, the TC corrector and free-slip
walls.  Its striped-kernel rule (x-periodic topologies need a 128-multiple
nx) was a lane-padding artefact of the TPU and does not apply.  The kernel
takes the geometry of :func:`..models.combustion.build_geometry`.

``first_step`` runs the first step of the call without the LI2014
conjugate fix, as :func:`..models.combustion.run` does; ``all_first_steps``
runs every step so, which is the shipped reference binary's behaviour (its
``first_step`` flag is never cleared, ``tests/test_combustion_parity.py``).

Each call counts its steps and launches in the recorder of
:mod:`..utils.profiling` (``kernel.steps.combustion_step``,
``kernel.launches.combustion_step``), so a run can show that its main path
went through the kernel, and records the ``kernel.prepare`` and
``kernel.enqueue`` spans.

:func:`step_fused_halo` is the counterpart of ``pallas_combustion.
step_fused_halo``, the halo-in entry of the decomposed channel
(``parallel/sharding.make_fused_combustion_step``): the same kernel in its
slab mode (a slab of rows of the global lattice, each row's boundary role
decided by its global row; see the source's header note), ``nsub`` steps on
a halo-extended slab, then the interior.  Its steps and launches count
apart, with ``.halo`` after the counters' names; :func:`step_halo_plain` is
its plain version.  :func:`run_fused` is the same slab mode on the whole lattice.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, _halo
from ._checks import check_tensors, on_card
from ..models import combustion as cbm
from ..models.combustion import (C, M_MAT, Q, W, CombustionParams,
                                 CombustionState)
from ..utils.profiling import span

FAMILY = "combustion_step"

# Rows a step reads away from a row of the slab: the LI2014 conjugate link
# (1), the one-sided gradients next to a solid (2) and the streaming (1), as
# JAX's STRIPE_REACH counts them.  The kernel's own chains are no longer: a
# cell's new populations read the fields at most 3 rows away (pushed from a
# neighbour whose one-sided gradient reads 2 rows beyond it) and g_coll at
# most 2 (the conjugate fix of the neighbour's incoming g_T).  The boundary
# phase adds nothing: its wall-row fixes read the 2 rows inward of rows 1 and
# ny − 2, and only rows on that inward side, within 3 rows of the wall row,
# read the fixed values back (beyond the wall row lie the wall rows 0 and
# ny − 1, which take nothing from it but g_T at the wall, and give nothing).
# After nsub steps only the outer REACH · nsub rows of a slab can differ
# from the whole-lattice run.
REACH = 4

TOPOLOGIES = ("inflow_outflow", "cavity", "couette", "poiseuille")

_DOUBLES = ("t367", "t76", "wsum_bot", "wsum_top", "conj_neg_a", "conj_a",
            "conj_b2", "conj_c2", "half_dpdx", "half_dpdy", "dpdx", "dpdy",
            "D_O2", "D_CO2", "fac_O2", "fac_CO2", "fac_T", "A_pre", "neg_E",
            "R_id", "half_stoich", "M_CO2", "DM", "M_O2", "delta_hr",
            "cp_gas")
_INTS = ("io", "konv", "li2014", "body_force", "solid_reaction")
# the kernel's collisions, in the order of CombustionConst.lr_a
COLLISIONS = ("flow", "O2", "CO2", "T", "T_solid", "body_force")
# |M_j|²: the rows of M_MAT are orthogonal, so M⁻¹ = Mᵀ diag(1 / |M_j|²)
_M_NORM2 = (M_MAT ** 2).sum(axis=1)


class _CombustionConst(ctypes.Structure):
    """Mirror of ``struct CombustionConst`` in ``csrc/combustion_step.cu``
    (same order)."""
    _fields_ = ([("w2", ctypes.c_double * 9)]
                + [(name, ctypes.c_double) for name in _DOUBLES[:4]]
                + [("amp_in", ctypes.c_double * 3)]
                + [(name, ctypes.c_double) for name in _DOUBLES[4:]]
                + [("lr_a", ctypes.c_double * len(COLLISIONS)),
                   ("lr_c", ctypes.c_double * (len(COLLISIONS) * Q))]
                + [(name, ctypes.c_int) for name in _INTS])


def unsupported(p: CombustionParams):
    """What of ``p`` the kernel does not cover (the refusals of the Pallas
    ``_check_supported``); empty when it covers ``p``."""
    return [name for name, bad in (
        (f"topology {p.topology!r}", p.topology not in TOPOLOGIES),
        (f"scheme {p.scheme!r} (li2014 or none)",
         p.scheme not in ("li2014", "none")),
        ("the TC corrector (temperature_coupling)", p.temperature_coupling),
        ("free-slip walls (y_freeslip)", p.y_freeslip)) if bad]


def check_params(p: CombustionParams):
    """Raise ``NotImplementedError`` unless the kernel covers ``p``."""
    refused = unsupported(p)
    if refused:
        raise NotImplementedError(
            "the combustion kernel does not cover " + ", ".join(refused)
            + "; use models.combustion.run (the plain path)")


def supported(p: CombustionParams) -> bool:
    """True iff the kernel covers ``p``."""
    return not unsupported(p)


def kernel_constants(p: CombustionParams, konv: bool) -> _CombustionConst:
    """Host-side constants of one parameter set, in float64, each formed as
    the plain path forms it from Python floats."""
    c = _CombustionConst()
    c.w2[:] = [2.0 * float(W[k]) for k in range(Q)]
    sig = p.sigma
    a = (1.0 - sig) / (1.0 + sig)
    body = bool(p.dpdx or p.dpdy)
    values = dict(
        t367=float(W[3] + W[7] + W[6]), t76=float(W[7] + W[6]),
        wsum_bot=sum(float(W[k]) for k in (2, 3, 6, 5, 7)),
        wsum_top=sum(float(W[k]) for k in (3, 4, 6, 7, 8)),
        conj_neg_a=-a, conj_a=a, conj_b2=2.0 / (1.0 + sig),
        conj_c2=2.0 * sig / (1.0 + sig),
        half_dpdx=p.dpdx / 2.0, half_dpdy=p.dpdy / 2.0, dpdx=p.dpdx,
        dpdy=p.dpdy, D_O2=p.D_O2, D_CO2=p.D_CO2,
        fac_O2=(p.tau_O2 - 0.5) / p.tau_O2,
        fac_CO2=(p.tau_CO2 - 0.5) / p.tau_CO2,
        fac_T=(p.tau_T - 0.5) / p.tau_T, A_pre=p.A_pre, neg_E=-p.E_akt,
        R_id=p.R_id, half_stoich=0.5 * p.stoich_O2, M_CO2=p.M_CO2,
        DM=p.D_CO2 * p.M_O2, M_O2=p.M_O2, delta_hr=p.delta_hr,
        cp_gas=p.cp_gas)
    for name, v in values.items():
        setattr(c, name, float(v))
    c.amp_in[:] = [p.Y_O2_inlet, p.Y_CO2_inlet, p.T_inlet]
    a, coef = low_rank_factors(p)
    c.lr_a[:] = a.tolist()
    c.lr_c[:] = coef.ravel().tolist()
    c.io = int(p.topology == "inflow_outflow")
    c.konv = int(konv)
    c.li2014 = int(p.scheme == "li2014")
    c.body_force = int(body)
    c.solid_reaction = int(p.solid_reaction)
    return c


def low_rank_factors(p: CombustionParams):
    """``(a, c)``, shapes ``(6,)`` and ``(6, 9)``: each collision of
    :data:`COLLISIONS`, M⁻¹ diag(S) M (the body force's with 1 − S/2 of the
    flow), as ``a I + Σ_j c_j M_jᵀ M_j`` over the rows M_j of ``M_MAT``,
    with ``a`` the most common rate of S and ``c_j = (S_j − a) / |M_j|²``.
    The kernel spends work only on the rates other than ``a``: none for g_T
    (BGK), two for each species, up to six for the flow (the Pallas
    kernel's ``_mrt_terms`` takes ``a = 1`` unless S is uniform)."""
    S_all = list(p.S_vectors())
    S_all.append(1.0 - 0.5 * S_all[0])
    a = np.empty(len(COLLISIONS))
    coef = np.empty((len(COLLISIONS), Q))
    for q, S in enumerate(S_all):
        rates, counts = np.unique(S, return_counts=True)
        a[q] = rates[np.argmax(counts)]
        coef[q] = (S - a[q]) / _M_NORM2
    return a, coef


def collision_matrix(a: float, coef) -> np.ndarray:
    """The (9, 9) matrix ``a I + Σ_j c_j M_jᵀ M_j`` of one collision's
    factors (:func:`low_rank_factors`)."""
    return a * np.eye(Q) + M_MAT.T @ (np.asarray(coef)[:, None] * M_MAT)


def kernel_tables(p: CombustionParams, device, dtype, rows=None):
    """The kernel's static inputs for ``p``'s geometry: the flags and ck_n
    (int8) and the momentum-exchange populations of column 0 and row ny − 1
    (``f_solid`` is zero elsewhere in every topology).
    ``rows`` (global row indices, default all) selects the rows of the flags,
    ck_n and column 0 that a slab holds; row ny − 1's stay whole."""
    flags, f_solid = cbm.build_geometry(p)
    tab = cbm.build_static_tables(flags, p)
    fs_col = f_solid[:, :, 0].copy()
    fs_row = f_solid[:, -1, :].copy()
    fs_row[:, 0] = 0.0
    rest = f_solid.copy()
    rest[:, :, 0] = 0.0
    rest[:, -1, :] = 0.0
    assert not rest.any(), "f_solid outside column 0 and row ny - 1"
    ck = tab["ck_n"]
    assert np.array_equal(ck, np.rint(ck)) and np.abs(ck).max() <= 2
    if rows is not None:
        flags, ck, fs_col = (np.ascontiguousarray(a) for a in (
            flags[rows], ck[:, rows], fs_col[:, rows]))
    as_t = dict(device=device)
    return dict(
        flags=torch.as_tensor(flags, dtype=torch.int8, **as_t),
        ckn=torch.as_tensor(ck.astype(np.int8), **as_t),
        fs_col=torch.as_tensor(fs_col, dtype=dtype, **as_t),
        fs_row=torch.as_tensor(fs_row, dtype=dtype, **as_t))


def slab_rows(p: CombustionParams, row0: int, ny_ext: int) -> np.ndarray:
    """The global rows ``(row0 + y) mod ny`` of a slab's ``ny_ext`` rows;
    raises when the slab is taller than the lattice (it would hold a global
    wall row twice)."""
    if not 1 <= ny_ext <= p.ny:
        raise ValueError(f"a slab of {ny_ext} rows does not fit a lattice of "
                         f"{p.ny} rows: it must hold each global row at most "
                         "once")
    return (row0 + np.arange(ny_ext)) % p.ny


def slab_tables(p: CombustionParams, row0: int, ny_ext: int, device, dtype):
    """:func:`kernel_tables` of the slab of ``ny_ext`` rows from global row
    ``row0`` (wrapping), the ``tables_ext`` of :func:`step_fused_halo`; its
    ``row0`` entry, ``row0 mod ny``, lets the entry refuse another slab's
    tables."""
    tb = kernel_tables(p, device, dtype, slab_rows(p, row0, ny_ext))
    tb["row0"] = row0 % p.ny
    return tb


def step_work(p: CombustionParams, konv: bool = True, rows=None) -> tuple:
    """(bytes, operations) that one kernel step with all four populations
    (``konv``) must move and do in float32 over the rows ``rows`` of ``p``'s
    lattice (global indices, default all), in the timed window (li2014, no
    first step), counted from the flags: f, g_O2, g_CO2 and g_T read and
    written (288 B a cell); the three forcing terms written at every cell
    (108 B) and read at the bulk cells only, where a step reads them (108 B a
    bulk cell); g_coll written at every cell (36 B) and read across the
    gas-obstacle interface only, one value per directed interface link
    ending at a cell of ``rows`` (a link's conjugate fix and its reverse's
    read the same two values); the flags and ck_n (1 + 9 B a cell); the
    momentum-exchange populations of column 0 and row ny − 1 (36 B a cell of
    them).  About 1,500 operations a cell (five 9 × 9 MRT products, four
    equilibria, the forcing terms, five one-sided gradients, nine interface
    mass fractions and the Arrhenius rate, as the dense collisions count
    them: the bound is set by the bytes either way); the boundary phase
    touches O(nx + ny) cells.  Flow only: f read and written and the flags
    (73 B a cell), the momentum-exchange populations, and about 250
    operations a cell (the moments, one equilibrium, one 9 × 9 MRT
    product)."""
    flags, _ = cbm.build_geometry(p)
    gas, obst = flags == cbm.BULK, flags == cbm.OBSTACLE
    links = np.zeros(flags.shape, dtype=np.int64)
    for cx, cy in cbm.C[1:]:
        shift = (int(cy), int(cx))     # the flag of the upstream cell r − c
        links += ((obst & np.roll(gas, shift, (0, 1)))
                  | (gas & np.roll(obst, shift, (0, 1))))
    rows = np.arange(p.ny) if rows is None else np.asarray(rows)
    cells = len(rows) * p.nx
    fs = 36 * (p.nx + len(rows))
    if not konv:
        return cells * 73 + fs, cells * 250
    nbytes = (cells * (288 + 108 + 36 + 10) + int(gas[rows].sum()) * 108
              + int(links[rows].sum()) * 4 + fs)
    return nbytes, cells * 1500


def _local_row(g: int, row0: int, ny: int, ny_glob: int) -> int:
    """The local row of a slab of ``ny`` rows from global row ``row0`` that
    holds global row ``g``, or −1 when the slab has none."""
    y = (g - row0) % ny_glob
    return y if y < ny else -1


def _flow_outlet_plain(f, row0: int, p: CombustionParams):
    """Column nx − 1 of the slab ``f`` (9, ny, nx) after the flow outlet
    (``apply_flow_outlet``) at every row whose global row g is 1 .. ny − 2
    of ``p``'s lattice (the corner formulas at g = 1 and ny − 2), the other
    rows as they were: (9, ny)."""
    _, ny, nx = f.shape
    cxs, cys = (torch.as_tensor(C[:, d], dtype=f.dtype, device=f.device)
                for d in (0, 1))
    macro = [(col.sum(0), (cxs[:, None] * col).sum(0) / col.sum(0),
              (cys[:, None] * col).sum(0) / col.sum(0))
             for col in (f[:, :, nx - 2], f[:, :, nx - 3])]
    rho, ux, uy = ((4.0 * a - b) / 3.0 for a, b in zip(*macro))
    usqr = ux * ux + uy * uy             # the reference's un-scaled u²
    cu = [float(C[k, 0]) * ux + float(C[k, 1]) * uy for k in range(Q)]
    feq = [rho * float(W[k]) * (1.0 + 3.0 * cu[k] + 4.5 * cu[k] * cu[k]
                                - 1.5 * usqr) for k in range(Q)]
    col = f[:, :, nx - 1]
    out = col.clone()
    g = torch.as_tensor((row0 + np.arange(ny)) % p.ny, device=f.device)
    inner = (g > 1) & (g < p.ny - 2)
    e1 = (rho * ux - col[1] - col[5] - col[8] + feq[6] + feq[3] + feq[7]) \
        / float(W[3] + W[7] + W[6])
    e2 = (rho * uy - col[2] - col[5] + col[8] + col[4] - feq[6] + feq[7]) \
        / float(W[7] + W[6])
    out[3] = torch.where(inner, feq[3] + 2.0 / 3.0 * rho * ux + 2.0 / 3.0 * (
        feq[3] - col[1] + feq[7] - col[5] + feq[6] - col[8]), out[3])
    out[6] = torch.where(inner, feq[6] - float(W[6]) * (e1 - e2), out[6])
    out[7] = torch.where(inner, feq[7] - float(W[7]) * (e1 + e2), out[7])
    for y in (_local_row(1, row0, ny, p.ny), _local_row(p.ny - 2, row0, ny,
                                                          p.ny)):
        if y < 0:
            continue
        bottom = int(g[y]) == 1
        r, vx, vy, cc = rho[y], ux[y], uy[y], col[:, y]
        f8 = (r + r * vx - (2.0 / 3.0) * r * vy - cc[0]
              - 2.0 * (cc[1] + cc[4] + cc[8])) / 2.0 if bottom else \
            (r + r * vx + (2.0 / 3.0) * r * vy - cc[0]
             - 2.0 * (cc[1] + cc[2] + cc[5])) / 2.0
        out[8, y] = f8
        out[6, y] = f8 - r * vx / 6.0 + r * vy / 6.0
        out[3, y] = cc[1] - 2.0 / 3.0 * r * vx
        out[7, y] = cc[5] - r * vx / 6.0 + r * vy / 6.0
        if bottom:
            out[2, y] = cc[4] + 2.0 / 3.0 * r * vy
        else:
            out[4, y] = cc[2] - 2.0 / 3.0 * r * vy
    return out


def _scalar_boundary_plain(g, amp_in: float, species: bool, f_out, yt: int,
                           yb: int):
    """The boundary launch for one scalar population ``g`` (9, ny, nx) of a
    slab, from its entry values only, cell by cell as the kernel's
    ``ScalarBoundary`` forms them: ``{(y, x): (9,) values}`` of every cell
    of rows ``yt`` and ``yb`` (−1: absent) and columns 1 and nx − 1.
    ``f_out``: the outlet-fixed flow column (:func:`_flow_outlet_plain`)."""
    _, ny, nx = g.shape
    w2 = [2.0 * float(W[k]) for k in range(Q)]
    xs = torch.arange(nx, device=g.device)

    def sums(y, x):
        return g[:, y, x].sum(0)

    def amp_out(y):
        return (4.0 * sums(y, nx - 2) - sums(y, nx - 3)) / 3.0

    def col_fixed_sum(y, x):
        e = g[:, y, x]
        if x == 1:
            a, pairs = amp_in, ((5, 7), (1, 3), (8, 6))
        else:
            a, pairs = amp_out(y), ((6, 8), (3, 1), (7, 5))
        return e.sum(0) + sum((-e[ko] + w2[ko] * a) - e[ki] for ki, ko in pairs)

    def amp_top():                      # A, at every column
        m = []
        for y in ((yt - 1) % ny, (yt - 2) % ny):
            s = sums(y, xs).clone()
            s[1] = col_fixed_sum(y, 1)
            s[nx - 1] = col_fixed_sum(y, nx - 1)
            m.append(s)
        return (4.0 * m[0] - m[1]) / 3.0

    def top_fixed():                    # B: row yt, (9, nx)
        v, a = g[:, yt].clone(), amp_top()
        v[7], v[4], v[8] = (-v[5] + w2[7] * a, -v[2] + w2[2] * a,
                            -v[6] + w2[6] * a)
        return v

    def bottom_fixed():                 # C: row yb, from the sums after B
        m = [top_fixed().sum(0) if y == yt else sums(y, xs)
             for y in ((yb + 1) % ny, (yb + 2) % ny)]
        v, a = g[:, yb].clone(), (4.0 * m[0] - m[1]) / 3.0
        v[6], v[2], v[5] = (-v[8] + w2[8] * a, -v[4] + w2[4] * a,
                            -v[7] + w2[7] * a)
        return v

    rows = {y: fix() for y, fix in ((yt, top_fixed), (yb, bottom_fixed))
            if y >= 0}
    cells = {}
    for y in range(ny):
        v = rows[y] if y in rows else g[:, y].clone()
        for x in (range(nx) if y in rows else (1, nx - 1)):
            cells[(y, x)] = v[:, x].clone()
    for (y, x), v in cells.items():
        if x == 1:                      # D
            v[5], v[1], v[8] = (-v[7] + w2[7] * amp_in,
                                -v[3] + w2[3] * amp_in,
                                -v[6] + w2[6] * amp_in)
        elif x == nx - 1 and not (species and y in rows):   # E
            a = amp_out(y)
            v[6], v[3], v[7] = (-v[8] + w2[8] * a, -v[1] + w2[1] * a,
                                -v[5] + w2[5] * a)
        elif x == nx - 1:               # F, a species corner
            bottom = y == yb
            Ylok = (4.0 * rows[y][:, nx - 2].sum() - rows[y][:, nx - 3].sum()) \
                / 3.0
            fc = f_out[:, y]
            rl = fc.sum()
            uxl = sum(float(C[k, 0]) * fc[k] for k in range(Q)) / rl
            uyl = sum(float(C[k, 1]) * fc[k] for k in range(Q)) / rl
            usqr = 1.5 * (uxl * uxl + uyl * uyl)
            Yc = v.sum()
            cu = [float(C[k, 0]) * uxl + float(C[k, 1]) * uyl
                  for k in range(Q)]
            geq = [Yc * float(W[k]) * (1.0 + 3.0 * cu[k] + 4.5 * cu[k] * cu[k]
                                       - usqr) for k in range(Q)]
            eps_k, geq_k = (((0, 1, 4, 8), (2, 3, 5, 6, 7)) if bottom
                            else ((0, 1, 2, 5), (3, 4, 6, 7, 8)))
            GC = (Ylok - (sum(v[k] for k in eps_k)
                          + sum(geq[k] for k in geq_k))) \
                / sum(float(W[k]) for k in geq_k)
            for k in geq_k:
                v[k] = geq[k] + float(W[k]) * GC
    return cells


def boundary_plain(args8, p: CombustionParams, row0: int = 0) -> tuple:
    """The plain version of the kernel's boundary phase on a slab of ``p``'s
    lattice whose local row 0 is global row ``row0`` (the whole lattice at
    row0 = 0): f, g_O2, g_CO2 and g_T of ``args8`` (the first four, (9, ny,
    nx)) after the flow outlet and the scalar boundary fixes, each boundary
    cell's values formed from the entry state alone, as the boundary launch
    forms them for the fields launch to copy (new tensors).  Rows whose
    fixes read across the slab's edges wrap inside the slab, as the
    kernel's do."""
    f = args8[0]
    _, ny, nx = f.shape
    yt, yb = (_local_row(g, row0, ny, p.ny) for g in (p.ny - 2, 1))
    f_out = _flow_outlet_plain(f, row0, p)
    out = [f.clone()]
    out[0][:, :, nx - 1] = f_out
    for g, amp_in, species in zip(args8[1:4], (p.Y_O2_inlet, p.Y_CO2_inlet,
                                               p.T_inlet), (True, True, False)):
        fixed = g.clone()
        for (y, x), v in _scalar_boundary_plain(g, amp_in, species, f_out, yt,
                                                yb).items():
            fixed[:, y, x] = v
        out.append(fixed)
    return tuple(out)


def _check_fields(named, ny: int, nx: int):
    """Raise unless every ``(name, tensor)`` of ``named`` is a contiguous
    tensor of the first one's float dtype and device, of shape
    ``(9, ny, nx)`` (``(ny, nx)`` for q_heat)."""
    if 8 * Q * ny * nx >= 2 ** 31:
        raise ValueError(f"{ny} x {nx} is too large for 32-bit indices")
    check_tensors(*((name, t, (ny, nx) if name == "q_heat" else (Q, ny, nx))
                    for name, t in named))


def check_state(state, p: CombustionParams):
    """Raise unless ``state`` is a :class:`CombustionState` of contiguous
    tensors of one float dtype and one device with the shapes ``p`` gives."""
    if not isinstance(state, CombustionState):
        raise TypeError("state must be a CombustionState")
    if p.ny < 5 or p.nx < 5:
        raise ValueError(f"the boundary phase needs ny >= 5 and nx >= 5, got "
                         f"{p.ny} x {p.nx}")
    _check_fields(list(zip(CombustionState._fields, state)), p.ny, p.nx)


def _check_slab(args8, p: CombustionParams):
    """Raise unless ``args8`` holds the first eight state fields of one slab
    of ``p``'s lattice: ``(9, ny_ext, nx)`` each, ``ny_ext <= ny``."""
    if not isinstance(args8, (tuple, list)) or len(args8) != 8:
        raise TypeError("args8 must hold the 8 state arrays f .. g_coll")
    if p.ny < 5 or p.nx < 5:
        raise ValueError(f"the boundary phase needs ny >= 5 and nx >= 5, got "
                         f"{p.ny} x {p.nx}")
    if not isinstance(args8[0], torch.Tensor) or args8[0].dim() != 3:
        raise TypeError("f must be a (9, ny_ext, nx) torch tensor")
    slab_rows(p, 0, args8[0].shape[1])
    _check_fields(list(zip(CombustionState._fields[:8], args8)),
                  args8[0].shape[1], p.nx)


def _check_tables(tb, row0: int, p: CombustionParams, ny: int, device,
                  dtype):
    """Raise unless ``tb`` holds the kernel's static inputs for the slab of
    ``ny`` rows from global row ``row0`` of ``p``'s lattice on ``device``
    (:func:`slab_tables`)."""
    nx = p.nx
    want = {"flags": ((ny, nx), torch.int8), "ckn": ((Q, ny, nx), torch.int8),
            "fs_col": ((Q, ny), dtype), "fs_row": ((Q, nx), dtype)}
    for name, (shape, dt) in want.items():
        t = tb.get(name) if isinstance(tb, dict) else None
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape \
                or t.dtype != dt or t.device != device \
                or not t.is_contiguous():
            raise ValueError(f"tables_ext[{name!r}] must be a contiguous "
                             f"{dt} tensor of shape {shape} on {device} "
                             "(slab_tables)")
    if tb.get("row0") != row0 % p.ny:
        raise ValueError(f"tables_ext were built for global row "
                         f"{tb.get('row0')}, the slab starts at row "
                         f"{row0 % p.ny} (slab_tables of the same row0)")


def _plain(state, p, n_steps, konv, first_step, all_first_steps):
    if all_first_steps:
        step, _ = cbm.make_step(p, konv=konv, first_step=True)
        for _ in range(n_steps):
            state = step(state)
        return state
    return cbm.run(state, p, n_steps, konv=konv, first_step=first_step)


_TABLES = {}


def run_fused(state: CombustionState, p: CombustionParams, n_steps: int,
              konv: bool = True, first_step: bool = False,
              all_first_steps: bool = False) -> CombustionState:
    """Advance ``n_steps`` steps (see the module docstring for
    ``first_step`` and ``all_first_steps``)."""
    check_params(p)
    check_state(state, p)
    if not on_card(state.f, n_steps):
        return _plain(state, p, n_steps, konv, first_step, all_first_steps)
    key = (p, str(state.f.device), state.f.dtype)
    if key not in _TABLES:
        _TABLES.clear()
        _TABLES[key] = kernel_tables(p, state.f.device, state.f.dtype)
    mode = 2 if all_first_steps else (1 if first_step else 0)
    out = _launch(state[:8], _TABLES[key], p, 0, n_steps, konv, mode)
    if konv:
        return CombustionState(*out, state.q_heat)
    return CombustionState(out[0], *state[1:])


def launches_per_step(p: CombustionParams, konv: bool) -> int:
    """Kernel launches a step: the collide-and-stream, the fields with all
    four populations, and the boundary phase in the inflow/outflow channel
    with all four (``run_steps`` in the source)."""
    return 1 + int(konv) + int(konv and p.topology == "inflow_outflow")


def _launch(args8, tb, p: CombustionParams, row0: int, n_steps: int,
            konv: bool, mode: int, halo_route: bool = False) -> tuple:
    """``n_steps`` kernel steps of the slab ``args8`` (CUDA tensors of
    ``(9, ny, nx)``; the whole lattice when ``ny == p.ny`` and ``row0`` is
    0) whose local row 0 is global row ``row0``, with the static inputs
    ``tb``; returns the 8 arrays after them (the first only is advanced
    without ``konv``).  ``mode``: the kernel's first_mode.  Counts them
    (``.halo`` for the halo route)."""
    with span("kernel.prepare", family=FAMILY, steps=n_steps):
        dtype, device = args8[0].dtype, args8[0].device
        consts = kernel_constants(p, konv)
        _, ny, nx = args8[0].shape
        a = torch.stack(list(args8))
        b = torch.empty_like(a)
        fld = torch.empty((5, ny, nx), dtype=dtype, device=device)
        side = torch.empty((3, Q, 2 * (nx + ny)), dtype=dtype, device=device)
    _build.enqueue(FAMILY, "combustion_run", args8[0], n_steps,
                   n_steps * launches_per_step(p, konv),
                   [(a.data_ptr(), b.data_ptr(), tb["flags"].data_ptr(),
                     tb["ckn"].data_ptr(), tb["fs_col"].data_ptr(),
                     tb["fs_row"].data_ptr(), fld.data_ptr(), side.data_ptr(),
                     ny, nx, row0 % p.ny, p.ny, n_steps, mode,
                     ctypes.addressof(consts))], halo_route)
    return (b if n_steps % 2 else a).unbind(0)


def step_halo_plain(args8, row0: int, p: CombustionParams,
                    konv: bool = True, nsub: int = 1, halo=None) -> tuple:
    """The plain version of :func:`step_fused_halo`, on any device: the slab
    written into a whole-lattice state at its global rows ``(row0 + y) mod
    ny`` (the other rows from :func:`..models.combustion.initialize`, finite
    values that reach only the cropped rows), ``nsub`` plain steps of that
    state, then the slab's interior rows.  The plain step takes the
    geometry from ``p``, so it needs no tables."""
    _check_slab(args8, p)
    ny_ext = args8[0].shape[1]
    halo = _halo.check(halo, REACH, nsub, ny_ext, "rows")
    dev, dtype = args8[0].device, args8[0].dtype
    rows = torch.as_tensor(slab_rows(p, row0, ny_ext), device=dev)
    whole = cbm.initialize(p, dtype, device=dev)
    st = CombustionState(*(w.index_copy(1, rows, t)
                           for w, t in zip(whole[:8], args8)), whole.q_heat)
    step, _ = cbm.make_step(p, konv=konv)
    for _ in range(nsub):
        st = step(st)
    return tuple(_halo.interior(t.index_select(1, rows), halo, 1)
                 for t in st[:8])


def step_fused_halo(args8, tables_ext, row0: int, p: CombustionParams,
                    konv: bool = True, nsub: int = 1, halo=None) -> tuple:
    """``nsub`` kernel steps on a slab whose halo rows are already filled;
    returns the 8 interior arrays ``(9, ny_ext − 2·halo, nx)``, new tensors.

    Args:
      args8: f, g_O2, g_CO2, g_T, the three forcing terms and g_coll, each
        ``(9, ny_ext, nx)`` with ``halo`` rows above and below the shard's
        own rows (float32 or float64, contiguous, one device); ``ny_ext`` at
        most ``p.ny``.
      tables_ext: the slab's static inputs, :func:`slab_tables` of the same
        ``row0`` and ``ny_ext`` on the same device and dtype; checked on
        every device, though the plain version on the CPU does not read
        them.
      row0: the global row of the slab's row 0 (negative or past the lattice
        wraps: ``shard_index · ny_loc − halo``).
      konv: all four populations; else the flow only, and the other seven
        arrays come back as their interior rows unchanged.
      halo: rows on each side, at least ``REACH · nsub`` (the default).  The
        Pallas kernel's 8-row tile, its 128-lane padding and its stripe
        height are Mosaic rules and do not apply here.
    Every step is a steady-state step (no first step), as in JAX.  The
    kernel's row index wraps at the slab's edges; that reaches at most
    ``REACH · nsub`` rows in, all of them cropped.
    """
    check_params(p)
    _check_slab(args8, p)
    ny_ext = args8[0].shape[1]
    halo = _halo.check(halo, REACH, nsub, ny_ext, "rows")
    card = on_card(args8[0])
    _check_tables(tables_ext, row0, p, ny_ext, args8[0].device,
                  args8[0].dtype)
    if not card:
        return step_halo_plain(args8, row0, p, konv, nsub, halo)
    out = _launch(args8, tables_ext, p, row0, nsub, konv, 0, halo_route=True)
    if not konv:
        out = out[:1] + tuple(args8[1:])
    return tuple(_halo.interior(t, halo, 1) for t in out)
