"""Pulsatile blood flow in a deformable 2D vessel (D2Q9 MRT, pressure form),
plain PyTorch.

Port of ``multiphase_lbm_tpu/models/pulsatile.py`` (reference
``Abbashub LBM/apps/PulsatileBloodFlow2D.h``): incompressible pressure-form
equilibrium, MRT (or BGK) collision, Zou/He pulsatile pressure inlet and
outlet, Bouzidi quadratic curved bounce-back on two moving walls, and a
pressure-driven deformable vessel with a geometry rebuild and fresh-node
seeding every step.  The four reference behaviours the JAX model
reproduces on purpose are kept: the ping-pong parity quirk, the k = 0
momentum quirk of the regular macro sweep, the sequential fresh-node
seeding on order-dependent steps, and the bottom-before-top Bouzidi order.

The JAX model's ``lax.cond`` dispatches become Python ``if``s on host
scalars (one or two device syncs a step), and its sequential reseed
``fori_loop`` a Python loop over the fresh cells on the host.  This module
is the plain path and the oracle that the CUDA kernel of
:mod:`..ops.pulsatile_fused` is held against.  Functions that create
tensors take a ``device``; the rest run on the device of their inputs.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.collision import (MRT_M_I, MRT_M_I_INV, MRT_M_K, MRT_M_K_INV,
                              bgk_collide, pressure_equilibrium)
from ..core.lattice import D2Q9, EX_I, EY_I, JB_I, K_FROM_I


@dataclasses.dataclass(frozen=True)
class PulsatileParams:
    """Driver constants (reference PulsatileBloodFlow2D.h:740-751) and the
    derived quantities of Setup_Simulation_Parameters (:152-172); the same
    fields, defaults and properties as the JAX ``PulsatileParams``.

    ``momentum_quirk=True`` reproduces the reference's momentum sweep, which
    omits k = 0 (the W direction in module ordering); ``False`` is the
    physics mode gated in :mod:`..validation.womersley`.  The three quirk
    flags below default to ``None``, which follows ``momentum_quirk``
    (see the JAX model for the measurements behind each)."""

    nx: int
    ny: int
    tau: float = 0.75
    s5: float = 1.0
    alpha: float = 0.01
    deformable: bool = True
    is_severed: bool = True
    p0_in: float = 0.20
    p0_out: float = 0.19
    t_beat: int = 0          # 0 → max(1, nx)
    hsize: int = 1
    collision: str = "mrt"   # "mrt" | "bgk"
    momentum_quirk: bool = True
    # collisions read the previous post-collision buffer (reference
    # ping-pong aliasing); None → follows momentum_quirk
    pingpong_quirk: bool | None = None
    # the I-ordered CONVERT matrix fed k-ordered populations; None →
    # follows momentum_quirk
    mrt_basis_quirk: bool | None = None
    # Zou & He corner-node closure where the pressure columns meet the
    # walls; None → enabled exactly when momentum_quirk is False
    zou_he_corner_closure: bool | None = None

    @property
    def pingpong(self) -> bool:
        if self.pingpong_quirk is None:
            return self.momentum_quirk
        return self.pingpong_quirk

    @property
    def mrt_basis_scrambled(self) -> bool:
        if self.mrt_basis_quirk is None:
            return self.momentum_quirk
        return self.mrt_basis_quirk

    @property
    def corner_closure(self) -> bool:
        if self.zou_he_corner_closure is None:
            return not self.momentum_quirk
        return self.zou_he_corner_closure

    @property
    def rho0(self):
        return 1.0 / self.hsize ** 3

    @property
    def S(self):
        s8 = 1.0 / self.tau
        return (1.0, 1.0, 1.0, 1.0, self.s5, 1.0, self.s5, s8, s8)

    @property
    def beat(self):
        return self.t_beat if self.t_beat > 0 else max(1, self.nx)

    @property
    def omega(self):
        return 2.0 * math.pi / float(self.beat)

    @property
    def pin(self):
        return 0.02 if self.is_severed else self.p0_in

    @property
    def pout(self):
        return 0.0 if self.is_severed else self.p0_out

    @property
    def p_tissue(self):
        return self.pin

    @property
    def p_osc(self):
        posc = self.pin - self.pout
        return posc * 0.1 if self.is_severed else posc

    @property
    def t_propagation(self):
        return int((self.nx - 1.0) * math.sqrt(3.0) - 1) * self.hsize

    @property
    def t_start(self):
        return 2 * self.t_propagation

    @property
    def t_sever(self):
        return 0

    @property
    def y0(self):
        return (self.ny - 1) // 2

    @property
    def yc(self):
        """Channel center Y0 + 0.5 used by the geometry formulas."""
        return self.y0 + 0.5


class PulsatileState(NamedTuple):
    """The reference's two ping-pong buffers (PulsatileBloodFlow2D.h:764-791):
    every collision reads the previous post-collision buffer ``g_coll``,
    while the macroscopic fields come from the streamed buffer
    ``g_stream``, which also feeds the solid cells of the next collision."""

    g_coll: torch.Tensor    # (9, ny, nx) next collision's distribution input
    g_stream: torch.Tensor  # (9, ny, nx) streamed state (macro + solid source)
    yr1: torch.Tensor       # (nx,) bottom wall position
    yr2: torch.Tensor       # (nx,) top wall position
    P: torch.Tensor         # (ny, nx)
    Ux: torch.Tensor
    Uy: torch.Tensor
    F: torch.Tensor         # Fobj with halo: (ny+2, nx+2), F[Y+1, X+1]
    fluid: torch.Tensor     # (ny, nx) bool


def _dot9(A, g):
    """``A @ g`` over the velocity index for a host matrix ``A`` (rows, 9):
    each row summed from k = 0 to 8, one rounding per product and per sum.
    That is the order of XLA's CPU dot at these shapes (so the port matches
    the JAX model bit for bit on the CPU), it is the same on every device,
    and the CUDA kernel sums the same way."""
    A = torch.as_tensor(np.asarray(A, dtype=np.float64), dtype=g.dtype,
                        device=g.device)[:, :, None, None]
    s = A[:, 0] * g[0]
    for k in range(1, 9):
        s = s + A[:, k] * g[k]
    return s


def _mrt_basis(p: PulsatileParams):
    """``(M, M⁻¹)``: the reference's scrambled basis, or the consistent
    k-ordered one."""
    return ((MRT_M_I, MRT_M_I_INV) if p.mrt_basis_scrambled
            else (MRT_M_K, MRT_M_K_INV))


def mrt_low_rank(p: PulsatileParams):
    """``(Mr, C)``, float64 host arrays: for each relaxed moment j
    (S_j ≠ 1) of the basis the parameters select, M's row j and the column
    (S_j − 1)·M⁻¹[:, j], so that M⁻¹ (S − I) M = Σ_j C_j ⊗ Mr_j."""
    M, Minv = _mrt_basis(p)
    rel = [j for j, s in enumerate(p.S) if s != 1.0]
    return (M[rel].reshape(len(rel), 9),
            np.array([(p.S[j] - 1.0) * Minv[:, j] for j in rel]).reshape(
                len(rel), 9))


def _div(a, s):
    """``a / s`` for a Python float ``s``, correctly rounded on every
    device: PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal, which differs by an ulp (and the model amplifies ulps)."""
    return a / torch.full_like(a, s)


def _maximum0(x):
    """``max(0, x)`` with NaN kept, as ``jnp.maximum`` keeps it."""
    return torch.maximum(torch.zeros_like(x), x)


# ───────────────────────── geometry: Fobj and flags ────────────────────────
def fobj_from_walls(yr1, yr2, p: PulsatileParams):
    """Implicit geometry field with halo (reference
    Initialize_Fobj_for_Vessel_Walls, :275-285): for Y ≤ Y0 the bottom
    wall, else the top wall; halo columns are linear extrapolations."""
    ny = p.ny
    yc = p.yc
    Y = torch.arange(-1, ny + 1, dtype=yr1.dtype, device=yr1.device)
    denom = Y - yc
    lower = (yr1[None, :] - yc) / denom[:, None]
    upper = (yr2[None, :] - yc) / denom[:, None]
    body = torch.where((Y[:, None] <= p.y0), lower, upper)
    left = 2.0 * body[:, 0] - body[:, 1]
    right = 2.0 * body[:, -1] - body[:, -2]
    return torch.cat([left[:, None], body, right[:, None]], dim=1)


def flags_from_fobj(F, p: PulsatileParams):
    """bulk where F ≥ 1 (reference :282-284)."""
    return F[1:-1, 1:-1] >= 1.0


# ───────────────────────── border Δ extraction ─────────────────────────────
def _find_delta(mA, mB, Y1):
    """Δ = max(0, 1 − |Y1/(mA − mB)|) (reference Find_Delta, :288-290)."""
    return _maximum0(1.0 - torch.abs(Y1 / (mA - mB)))


def border_deltas(F, yr1, yr2, p: PulsatileParams):
    """Dense per-cell per-I-direction Bouzidi Δ fields ``(8, ny, nx)`` of
    the bottom and the top wall, sentinel 2 (reference
    Update_Boundary_Nodes_{Bottom,Top}, :294-382): each column has one
    main border node (the solid cell just outside the wall) with up to five
    Δ entries, plus a jump node where the border row changes between
    neighbouring columns.  Slots follow D[0..7] = I − 1 (I: 1=E..8=SE)."""
    ny, nx = p.ny, p.nx
    dt, dev = yr1.dtype, yr1.device
    rows = torch.arange(ny, device=dev)[:, None]
    cols = torch.arange(nx, device=dev)

    def gather(Yrow, Xi):
        # out-of-range rows clamp, as a JAX gather does
        return F[torch.clamp(Yrow + 1, 0, ny + 1), Xi]

    def fluid_at(xoff, Yrow):                              # F(X+1+dx, Y+1) ≥ 1
        Xi = torch.clamp(cols + 1 + xoff, 0, nx + 1)
        return gather(Yrow, Xi) >= 1.0

    def one_wall(D, yr, bottom: bool):
        if bottom:
            Yx0 = torch.floor(yr).to(torch.int64)
            fl0 = gather(Yx0, cols + 1) >= 1.0
            Yx = torch.where(fl0, Yx0 - 1, Yx0)
        else:
            Yx0 = torch.ceil(yr).to(torch.int64)
            fl0 = gather(Yx0, cols + 1) >= 1.0
            Yx = torch.where(fl0, Yx0 + 1, Yx0)
        Yx = torch.clamp(Yx, 0, ny - 1)

        yr_w = torch.roll(yr, 1)     # yr[X-1]
        yr_e = torch.roll(yr, -1)    # yr[X+1]
        slope_e = yr_e - yr
        slope_w = yr - yr_w
        dist = yr - Yx.to(dt)

        first = cols == 0
        last = cols == nx - 1
        interior_e = ~last
        interior_w = ~first
        main = rows == Yx[None, :]
        every = torch.ones_like(first)

        def setD(D, slot, cond_cols, val_cols):
            upd = main & cond_cols[None, :]
            D[slot] = torch.where(upd, val_cols[None, :], D[slot])

        if bottom:
            setD(D, 0, interior_e & fluid_at(1, Yx),
                 _find_delta(0.0, slope_e, dist))
            setD(D, 1, every, 1.0 - (yr - Yx.to(dt)))
            setD(D, 2, interior_w & fluid_at(-1, Yx),
                 _find_delta(0.0, slope_w, dist))
            setD(D, 4, interior_e & fluid_at(1, Yx + 1),
                 _find_delta(1.0, slope_e, dist))
            setD(D, 5, interior_w & fluid_at(-1, Yx + 1),
                 _find_delta(-1.0, slope_w, dist))
        else:
            setD(D, 0, interior_e & fluid_at(1, Yx),
                 _find_delta(0.0, slope_e, dist))
            setD(D, 2, interior_w & fluid_at(-1, Yx),
                 _find_delta(0.0, slope_w, dist))
            setD(D, 3, every, 1.0 - (Yx.to(dt) - yr))
            setD(D, 6, interior_w & fluid_at(-1, Yx - 1),
                 _find_delta(1.0, slope_w, dist))
            setD(D, 7, interior_e & fluid_at(1, Yx - 1),
                 _find_delta(-1.0, slope_e, dist))

        # jump nodes between columns X-1 and X (:307-313, :352-358)
        Y_prev = torch.roll(Yx, 1)
        changed = (Yx != Y_prev) & (~first)
        up = changed & (Yx > Y_prev)
        dn = changed & (Yx < Y_prev)
        Yx_l = torch.roll(Yx, -1)
        if bottom:
            # up: extra node at (X, Y_prev), D[5]; down: at (X-1, Yx), D[4]
            val_up = _find_delta(-1.0, slope_w, yr - Y_prev.to(dt))
            val_dn = _find_delta(1.0, slope_w, yr_w - Yx.to(dt))
            m_up = (rows == Y_prev[None, :]) & up[None, :]
            D[5] = torch.where(m_up, val_up[None, :], D[5])
            m_dn = (rows == Yx_l[None, :]) & torch.roll(dn, -1)[None, :]
            D[4] = torch.where(m_dn, torch.roll(val_dn, -1)[None, :], D[4])
        else:
            # up: extra node at (X-1, Yx), D[7]; down: at (X, Y_prev), D[6]
            val_up = _find_delta(-1.0, slope_w, yr_w - Yx.to(dt))
            val_dn = _find_delta(1.0, slope_w, yr - Y_prev.to(dt))
            m_up = (rows == Yx_l[None, :]) & torch.roll(up, -1)[None, :]
            D[7] = torch.where(m_up, torch.roll(val_up, -1)[None, :], D[7])
            m_dn = (rows == Y_prev[None, :]) & dn[None, :]
            D[6] = torch.where(m_dn, val_dn[None, :], D[6])
        return D

    D1 = one_wall(torch.full((8, ny, nx), 2.0, dtype=dt, device=dev), yr1,
                  bottom=True)
    D2 = one_wall(torch.full((8, ny, nx), 2.0, dtype=dt, device=dev), yr2,
                  bottom=False)
    return D1, D2


# ───────────────────────── collision / BC / streaming ──────────────────────
def collide(state: PulsatileState, p: PulsatileParams, dense_mrt=False):
    """MRT (or BGK) collision on fluid cells (reference MRT_Collision
    :533-541).  Solid cells of the output keep ``g_stream`` (the reference's
    ping-pong aliasing, which steep staircase walls do read).

    The MRT takes the Pallas kernel's low-rank form,
    g_eq − Σ_j (S_j − 1) M⁻¹[:, j] (M_j · (g − g_eq)) over the relaxed
    moments, which the CUDA kernel computes too.  ``dense_mrt`` takes the
    JAX model's form instead, g − A·(g − g_eq) with A = M⁻¹ S M, which
    rounds differently: with it a free run follows the JAX model's op-by-op
    evaluation to rounding (tests/test_torch_pulsatile.py holds 27 steps at
    N = 64 to 1e-12, where the low-rank form drifts further: the model
    amplifies the different roundings)."""
    geq = pressure_equilibrium(state.P, torch.stack([state.Ux, state.Uy]),
                               p.rho0, D2Q9)
    gin = state.g_coll if p.pingpong else state.g_stream
    if p.collision != "mrt":
        gout = bgk_collide(gin, geq, 1.0 / p.tau)
    elif dense_mrt:
        M, Minv = _mrt_basis(p)
        A = Minv @ np.diag(np.asarray(p.S, dtype=np.float64)) @ M
        gout = gin - _dot9(A, gin - geq)
    else:
        Mr, C = mrt_low_rank(p)
        gout = geq.clone()
        if len(Mr):
            mom = _dot9(Mr, gin - geq)
            for r in range(len(Mr)):
                gout = gout - torch.as_tensor(
                    C[r], dtype=geq.dtype, device=geq.device)[:, None, None] \
                    * mom[r]
    return torch.where(state.fluid[None], gout, state.g_stream)


def _shift_xy(a, ex, ey):
    """Value at (Y+ey, X+ex) with wrap (callers mask out-of-domain)."""
    return torch.roll(a, (-ey, -ex), dims=(-2, -1))


# Δ slots (= I − 1) that each wall's border_deltas fills; the others hold
# the sentinel and write nothing
BOTTOM_SLOTS = (0, 1, 2, 4, 5)      # I ∈ {1 E, 2 N, 3 W, 5 NE, 6 NW}
TOP_SLOTS = (0, 2, 3, 6, 7)         # I ∈ {1 E, 3 W, 4 S, 7 SW, 8 SE}


def bouzidi(gout, F, deltas, p: PulsatileParams):
    """Quadratic Bouzidi interpolation writing border-cell populations
    (reference Bouzidi_quadratic, :553-601) for the bottom and top Δ
    fields of :func:`border_deltas`: the bottom wall's pass, then the top
    wall's, which reads the bottom pass's writes (in narrow passages a
    top-wall link samples a bottom-wall border cell)."""
    for delta, slots in zip(deltas, (BOTTOM_SLOTS, TOP_SLOTS)):
        gout = _bouzidi_one(gout, F, delta, p, slots)
    return gout


@functools.lru_cache(maxsize=64)
def _domain_masks(ny, nx, ex, ey, device):
    """``(in1, in2, in3, ~in2)``: whether the m-th neighbour along (ex, ey)
    lies in the lattice, m = 1, 2, 3 (static, so built once per shape)."""
    X = torch.arange(nx, device=device)[None, :]
    Y = torch.arange(ny, device=device)[:, None]
    ins = [(X + m * ex >= 0) & (X + m * ex < nx)
           & (Y + m * ey >= 0) & (Y + m * ey < ny) for m in (1, 2, 3)]
    return (*ins, ~ins[1])


def _bouzidi_one(gout, F, delta, p: PulsatileParams, slots):
    """One wall pass: every read from ``gout``, every write to ``new``.
    Samples come from zero-padded copies; a sample outside the lattice only
    reaches lanes that the in-domain masks discard (the JAX model wraps
    there instead)."""
    ny, nx = p.ny, p.nx
    gp = torch.nn.functional.pad(gout, (3, 3, 3, 3))
    Fp = torch.nn.functional.pad(F[1:-1, 1:-1], (3, 3, 3, 3))
    new = gout.clone()

    for slot in slots:
        I = slot + 1
        D = delta[slot]
        ex, ey = int(EX_I[I]), int(EY_I[I])
        kI = int(K_FROM_I[I])
        kJ = int(K_FROM_I[JB_I[I]])

        def at(a, m):          # value at (Y + m·ey, X + m·ex)
            y0, x0 = 3 + m * ey, 3 + m * ex
            return a[..., y0:y0 + ny, x0:x0 + nx]

        in1, in2, in3, out2 = _domain_masks(ny, nx, ex, ey, gout.device)
        active = (D < 1.0) & in1                       # :572
        gJ1, gJ2, gJ3 = at(gp[kJ], 1), at(gp[kJ], 2), at(gp[kJ], 3)
        gI1, gI2 = at(gp[kI], 1), at(gp[kI], 2)
        F1, F2, F3 = at(Fp, 1), at(Fp, 2), at(Fp, 3)

        # the reference's fallback order (:573-579):
        #   n2 → n1 when OOB; then n2 → n1 when F(n2)<1 (F at post-OOB n2)
        #   n3 → n1 when OOB; then n3 → n2_final when F(n3)<1 (post-OOB n3)
        F2_eff = torch.where(in2, F2, F1)
        use1for2 = out2 | (F2_eff < 1.0)
        gJ2 = torch.where(use1for2, gJ1, gJ2)
        gI2 = torch.where(use1for2, gI1, gI2)
        F3_eff = torch.where(in3, F3, F1)
        gJ3 = torch.where(in3, gJ3, gJ1)
        gJ3 = torch.where(F3_eff < 1.0, gJ2, gJ3)

        # (1 ± 2Δ) formed once, each product in the reference's order
        a, b = 1 + 2 * D, 1 - 2 * D
        lt = gJ1 * a * D + gJ2 * b * a - gJ3 * b * D
        ge = (gJ1 - gI1 * b * a + gI2 * b * D) / (D * a + 1e-30)
        val = torch.where(D < 0.5, lt, ge)
        new[kI] = torch.where(active, val, new[kI])
    return new


def stream_pull(gout):
    """Pull streaming, periodic in x (reference Streaming, :603-616; the y
    wrap reads land on rows that are always solid)."""
    out = []
    for k in range(9):
        cx, cy = int(D2Q9.c[k][0]), int(D2Q9.c[k][1])
        out.append(torch.roll(gout[k], (cy, cx), dims=(0, 1)))
    return torch.stack(out)


def _waveforms(t, tt, p: PulsatileParams):
    """Inlet and outlet pressures at step ``t`` (reference :619-620,
    :644-648), formed in ``tt``'s dtype as JAX forms them."""
    Pin = (p.pin + p.p_osc * torch.sin(p.omega * (tt + 1 - p.t_start))
           if t >= p.t_start else torch.full_like(tt, p.pin))
    if t >= p.t_start + p.t_propagation:
        Pout = p.pout + p.p_osc * torch.sin(
            p.omega * (tt + 1 - p.t_start - p.t_propagation))
    else:
        Pout = torch.full_like(tt, p.pout)
    if p.is_severed and t > p.t_sever:
        Pout = torch.zeros_like(tt)
    return Pin, Pout


def zou_he(g, yr1, yr2, t, p: PulsatileParams):
    """Zou/He pressure inlet (x = 0) and outlet (x = nx − 1) in I-space
    (reference :618-669); ``t`` is the step index (a Python int)."""
    dt, dev = g.dtype, g.device
    rho0 = p.rho0
    rows = torch.arange(p.ny, device=dev)
    kf = [int(K_FROM_I[i]) for i in range(9)]
    Pin, Pout = _waveforms(int(t), torch.tensor(float(t), dtype=dt,
                                                 device=dev), p)
    cc = p.corner_closure
    g = g.clone()

    def row_range(a, b):
        lo = torch.clamp_min(torch.ceil(a - 0.01).to(torch.int64), 0)
        hi = torch.clamp_max(torch.floor(b + 0.01).to(torch.int64), p.ny - 1)
        m = (rows >= lo) & (rows <= hi)
        if cc:
            # corner rows get the dedicated closure below, not the bulk form
            return lo, hi, m & (rows != lo) & (rows != hi)
        return lo, hi, m

    # ---- inlet ----
    ylo, yhi, m_b = row_range(yr1[0], yr2[0])
    col = g[:, :, 0]
    g0, g2, g3 = col[kf[0]], col[kf[2]], col[kf[3]]
    g4, g6, g7 = col[kf[4]], col[kf[6]], col[kf[7]]
    Uin = _div((Pin - g0 - g2 - 2 * g3 - g4 - 2 * g6 - 2 * g7) * 3.0, rho0)
    new = col.clone()
    new[kf[1]] = torch.where(m_b, g3 + 2.0 * rho0 / 9.0 * Uin, col[kf[1]])
    new[kf[5]] = torch.where(m_b, rho0 / 18.0 * Uin - 0.5 * (g2 - g4) + g7,
                             col[kf[5]])
    new[kf[8]] = torch.where(m_b, rho0 / 18.0 * Uin + 0.5 * (g2 - g4) + g6,
                             col[kf[8]])
    if cc:
        # Zou & He 1997 corner nodes, u = 0, pressure sum closed to Pin;
        # known populations read before the closure
        mb = rows == ylo
        mt = (rows == yhi) & (yhi != ylo)
        bl_d = 0.5 * (Pin - g0 - 2 * g3 - 2 * g4 - 2 * g7)   # NW = SE
        tl_d = 0.5 * (Pin - g0 - 2 * g2 - 2 * g3 - 2 * g6)   # NE = SW
        new[kf[1]] = torch.where(mb | mt, g3, new[kf[1]])
        new[kf[2]] = torch.where(mb, g4, new[kf[2]])
        new[kf[4]] = torch.where(mt, g2, new[kf[4]])
        new[kf[5]] = torch.where(mb, g7, torch.where(mt, tl_d, new[kf[5]]))
        new[kf[6]] = torch.where(mb, bl_d, new[kf[6]])
        new[kf[7]] = torch.where(mt, tl_d, new[kf[7]])
        new[kf[8]] = torch.where(mb, bl_d, torch.where(mt, g6, new[kf[8]]))
    g[:, :, 0] = new

    # ---- outlet ----
    ylo, yhi, m_b = row_range(yr1[-1], yr2[-1])
    col = g[:, :, -1]
    g0, g1, g2 = col[kf[0]], col[kf[1]], col[kf[2]]
    g4, g5, g8 = col[kf[4]], col[kf[5]], col[kf[8]]
    Uout = _div((g0 + 2 * g1 + g2 + g4 + 2 * g5 + 2 * g8 - Pout) * 3.0, rho0)
    new = col.clone()
    new[kf[3]] = torch.where(m_b, g1 - 2.0 * rho0 / 9.0 * Uout, col[kf[3]])
    new[kf[6]] = torch.where(m_b, -rho0 / 18.0 * Uout - 0.5 * (g2 - g4) + g8,
                             col[kf[6]])
    new[kf[7]] = torch.where(m_b, -rho0 / 18.0 * Uout + 0.5 * (g2 - g4) + g5,
                             col[kf[7]])
    if cc:
        mb = rows == ylo
        mt = (rows == yhi) & (yhi != ylo)
        br_d = 0.5 * (Pout - g0 - 2 * g1 - 2 * g4 - 2 * g8)  # NE = SW
        tr_d = 0.5 * (Pout - g0 - 2 * g1 - 2 * g2 - 2 * g5)  # NW = SE
        new[kf[3]] = torch.where(mb | mt, g1, new[kf[3]])
        new[kf[2]] = torch.where(mb, g4, new[kf[2]])
        new[kf[4]] = torch.where(mt, g2, new[kf[4]])
        new[kf[6]] = torch.where(mb, g8, torch.where(mt, tr_d, new[kf[6]]))
        new[kf[5]] = torch.where(mb, br_d, new[kf[5]])
        new[kf[8]] = torch.where(mt, tr_d, new[kf[8]])
        new[kf[7]] = torch.where(mb, br_d, torch.where(mt, g5, new[kf[7]]))
    g[:, :, -1] = new
    return g


def macroscopic(g, fluid, p: PulsatileParams):
    """P = Σg, U = 3 Σ g c/ρ₀; zeros at solids (reference :216-230).  With
    ``momentum_quirk`` the momentum sum omits k = 0 (the W direction), as
    the reference's loop does (:224)."""
    c = np.asarray(D2Q9.c, dtype=np.float64).copy()
    if p.momentum_quirk:
        c[0] = 0.0
    P = _dot9(np.ones((1, 9)), g)[0]
    mom = _dot9(c.T, g)
    m = fluid.to(g.dtype)
    return (P * m, _div(3.0 * mom[0], p.rho0) * m,
            _div(3.0 * mom[1], p.rho0) * m)


# ───────────────────────── wall motion + reseeding ─────────────────────────
def move_walls(P, yr1, yr2, p: PulsatileParams):
    """Per-column wall relaxation toward the pressure-balanced position,
    displacement clamped to ±0.25 (reference :243-272)."""
    Ps1 = P[p.y0, :] - p.p_tissue
    t1 = 0.5 - _div(Ps1, p.alpha)
    d1 = torch.clamp(t1 - yr1, -0.25, 0.25)
    Ps2 = P[p.y0 + 1, :] - p.p_tissue
    t2 = (p.ny - 1 - 0.5) + _div(Ps2, p.alpha)
    d2 = torch.clamp(t2 - yr2, -0.25, 0.25)
    return yr1 + d1, yr2 + d2


# the JAX model's offsets of the 8 neighbours, in its ring-1 / 3x3 order
_NEIGH_OFF = [(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
              (-1, 1), (0, 1), (1, 1)]


def _ring_offsets(R):
    if R == 1:
        return [(1, 0), (-1, 0), (0, 1), (0, -1),
                (1, 1), (1, -1), (-1, 1), (-1, -1)]
    offs = [(sx, sy) for sx in range(-R, R + 1)
            for sy in (R - abs(sx), -(R - abs(sx)))]
    return list(dict.fromkeys(offs))


def _reseed_simultaneous(g, P, F_old, F_new, fluid_new, p: PulsatileParams):
    """Order-independent fill, used only for the fresh cells beyond
    ``RESEED_K`` on an order-dependent step (see reseed_fresh_nodes)."""
    ny, nx = p.ny, p.nx
    dt, dev = g.dtype, g.device
    Fo = F_old[1:-1, 1:-1]
    Fn = F_new[1:-1, 1:-1]
    fresh = (Fo < 1.0) & (Fn >= 1.0)

    cols = torch.arange(nx, device=dev)[None, :].expand(ny, nx)
    rows = torch.arange(ny, device=dev)[:, None].expand(ny, nx)
    is_edge = (cols == 0) | (cols == nx - 1)

    # inlet/outlet: copy the row toward the channel center (:408-422)
    below = rows < p.y0
    edge_fill = torch.where(below[None], torch.roll(g, -1, dims=1),
                            torch.roll(g, 1, dims=1))

    # interior: Ffrac-weighted 3x3 average (:465-490)
    Ffrac = _maximum0(torch.trunc(Fo).to(dt))
    sum_frac = Ffrac
    acc = torch.zeros_like(g)
    for ox, oy in _NEIGH_OFF:
        w_nb = _shift_xy(Ffrac, ox, oy)
        sum_frac = sum_frac + w_nb
        acc = acc + _shift_xy(g, ox, oy) * w_nb[None]
    weighted = acc / torch.clamp_min(sum_frac, 1e-30)[None]
    need_k = torch.zeros_like(g, dtype=torch.bool)
    for I in range(9):
        up_frac = _shift_xy(Ffrac, -int(EX_I[I]), -int(EY_I[I]))
        need_k[int(K_FROM_I[I])] = up_frac != 1.0
    interior_fill = torch.where(need_k, weighted, g)

    # ring-search fallback when no old-fluid neighbour exists (:424-463)
    no_frac = sum_frac <= 0.0
    m_new = fluid_new.to(dt)
    ring_fill = torch.zeros_like(g)
    ring_found = torch.zeros_like(m_new, dtype=torch.bool)
    for R in range(1, 5):
        offs = _NEIGH_OFF if R == 1 else _ring_offsets(R)
        cnt = torch.zeros_like(m_new)
        s = torch.zeros_like(g)
        for ox, oy in offs:
            in_dom = ((cols + ox >= 0) & (cols + ox < nx)
                      & (rows + oy >= 0) & (rows + oy < ny))
            wgt = _shift_xy(m_new, ox, oy) * in_dom.to(dt)
            cnt = cnt + wgt
            s = s + _shift_xy(g, ox, oy) * wgt[None]
        ok = (cnt > 0) & (~ring_found)
        ring_fill = torch.where(ok[None], s / torch.clamp_min(cnt, 1.0)[None],
                                ring_fill)
        ring_found = ring_found | (cnt > 0)
    geq0 = pressure_equilibrium(P, torch.zeros((2, ny, nx), dtype=dt,
                                               device=dev), p.rho0, D2Q9)
    ring_fill = torch.where(ring_found[None], ring_fill, geq0)

    interior_fill = torch.where(no_frac[None], ring_fill, interior_fill)
    fill = torch.where(is_edge[None], edge_fill, interior_fill)
    return torch.where((fresh & fluid_new)[None], fill, g)


RESEED_K = 256  # max fresh cells handled exactly per step
_PAD = 4


def reseed_fresh_nodes(g, P, F_old, F_new, fluid_new, p: PulsatileParams):
    """Fill cells that turned from solid to fluid (reference
    Update_Fobj_for_Vessel_Walls + Fill_Fluid_Node, :384-498).

    The reference fills fresh cells one by one in x-then-y order, and a fill
    can read a cell filled before it (the ring search, or an inlet/outlet
    copy whose source row is fresh too).  A dense pass computes every fill
    from the pre-reseed state; on a step where some fill reads a fresh
    cell (order-dependent) the exact sequential pass runs instead, and
    beyond ``RESEED_K`` fresh cells such a step takes the simultaneous
    fill (see the JAX model for the measurements)."""
    return _reseed(g, P, F_old, F_new, fluid_new, p)[0]


def _reseed(g, P, F_old, F_new, fluid_new, p: PulsatileParams):
    """``(g, n_fresh, order_dependent)``: the reseeded populations, the
    number of fresh cells, and whether the step was order-dependent."""
    Fo = F_old[1:-1, 1:-1]
    Fn = F_new[1:-1, 1:-1]
    fresh = (Fo < 1.0) & (Fn >= 1.0) & fluid_new
    n_fresh = int(fresh.sum())
    if n_fresh == 0:
        return g, 0, False
    return _reseed_dispatch(g, P, F_old, F_new, fluid_new, fresh, n_fresh, p)


def _dense_fill(g, Ffrac, fresh, p: PulsatileParams):
    """Every fill from the pre-reseed state ``g`` over the whole lattice,
    with the accumulation order of the sequential pass, and the map of
    fresh cells whose fill is order-dependent (the ring search is not
    computed: a cell that needs it is order-dependent by definition)."""
    ny, nx = p.ny, p.nx
    dt, dev = g.dtype, g.device
    stack = torch.cat([g, Ffrac[None], fresh[None].to(dt)], dim=0)
    # the sequential pass reads zero-padded windows: pad with zeros
    sp = torch.nn.functional.pad(stack, (1, 1, 1, 1))
    sum_frac = torch.zeros((ny, nx), dtype=dt, device=dev)
    acc = torch.zeros((9, ny, nx), dtype=dt, device=dev)
    rolled = {}
    for j in range(3):
        for i in range(3):
            ex, ey = i - 1, j - 1
            nb = sp[:, 1 + ey:1 + ey + ny, 1 + ex:1 + ex + nx]
            rolled[(ex, ey)] = nb
            Fnb = nb[9]
            sum_frac = sum_frac + Fnb
            acc = acc + nb[:9] * Fnb[None]
    weighted = acc / torch.clamp_min(sum_frac, 1e-30)[None]
    by_k = [None] * 9
    for I in range(9):
        need = rolled[(-int(EX_I[I]), -int(EY_I[I]))][9] != 1.0
        kI = int(K_FROM_I[I])
        by_k[kI] = torch.where(need, weighted[kI], g[kI])
    int_val = torch.stack(by_k)
    below = (torch.arange(ny, device=dev) < p.y0)[:, None]
    cols = torch.arange(nx, device=dev)[None, :]
    is_edge = (cols == 0) | (cols == nx - 1)
    edge_val = torch.where(below[None], rolled[(0, 1)][:9],
                           rolled[(0, -1)][:9])
    edge_src_fresh = torch.where(below, rolled[(0, 1)][10],
                                 rolled[(0, -1)][10]) > 0.5
    val = torch.where(is_edge[None], edge_val, int_val)
    dep_map = fresh & torch.where(is_edge, edge_src_fresh, sum_frac == 0.0)
    return val, dep_map


def _fill_val(gp, fluid_p, Ffrac_p, x, y, p: PulsatileParams):
    """One cell's fill from the padded populations ``gp`` (the JAX
    ``fill_val``, with its fixed accumulation order)."""
    yy, xx = y + _PAD, x + _PAD
    win = gp[:, yy - 4:yy + 5, xx - 4:xx + 5]
    fw = fluid_p[yy - 4:yy + 5, xx - 4:xx + 5]
    W3 = Ffrac_p[yy - 1:yy + 2, xx - 1:xx + 2]
    if x == 0 or x == p.nx - 1:
        # inlet/outlet: copy the row toward the channel center (:408-422)
        return (win[:, 5, 4] if y < p.y0 else win[:, 3, 4]).clone()

    # Ffrac-weighted 3x3 average (:465-490)
    sum_frac = torch.zeros((), dtype=gp.dtype)
    acc = torch.zeros(9, dtype=gp.dtype)
    for j in range(3):
        for i in range(3):
            sum_frac = sum_frac + W3[j, i]
            acc = acc + win[:, 3 + j, 3 + i] * W3[j, i]
    if bool(sum_frac != 0.0):
        weighted = acc / torch.clamp_min(sum_frac, 1e-30)
        val = win[:, 4, 4].clone()
        for I in range(9):
            kI = int(K_FROM_I[I])
            if bool(W3[1 - int(EY_I[I]), 1 - int(EX_I[I])] != 1.0):
                val[kI] = weighted[kI]
        return val

    # ring search on new-fluid cells (:425-463); none found: equilibrium
    # at (P=0, u=0), i.e. zeros (:459-462)
    for R in range(1, 5):
        cnt = torch.zeros((), dtype=gp.dtype)
        s = torch.zeros(9, dtype=gp.dtype)
        for ox, oy in _ring_offsets(R):
            wgt = fw[4 + oy, 4 + ox]
            cnt = cnt + wgt
            s = s + win[:, 4 + oy, 4 + ox] * wgt
        if bool(cnt > 0):
            return s / torch.clamp_min(cnt, 1.0)
    return torch.zeros(9, dtype=gp.dtype)


def _reseed_dispatch(g, P, F_old, F_new, fluid_new, fresh, n_fresh,
                     p: PulsatileParams):
    ny, nx = p.ny, p.nx
    dt = g.dtype
    Ffrac = _maximum0(torch.trunc(F_old[1:-1, 1:-1])).to(dt)
    val, dep_map = _dense_fill(g, Ffrac, fresh, p)
    if not bool(dep_map.any()):
        return torch.where(fresh[None], val, g), n_fresh, False

    # order-dependent step: the exact sequential pass, in x-major order
    # (the reference loop :389), on the host
    cpu = torch.device("cpu")
    pad = (_PAD, _PAD, _PAD, _PAD)
    gp = torch.nn.functional.pad(g.to(cpu), pad)
    fluid_p = torch.nn.functional.pad(fluid_new.to(cpu, dt), pad)
    Ffrac_p = torch.nn.functional.pad(Ffrac.to(cpu), pad)
    xs, ys = torch.nonzero(fresh.T.to(cpu), as_tuple=True)
    for x, y in zip(xs[:RESEED_K].tolist(), ys[:RESEED_K].tolist()):
        gp[:, y + _PAD, x + _PAD] = _fill_val(gp, fluid_p, Ffrac_p, x, y,
                                              p)
    g_seq = gp[:, _PAD:-_PAD, _PAD:-_PAD].contiguous().to(g.device)
    if n_fresh > RESEED_K:
        # cells beyond the bound: the order-independent simultaneous fill
        order = torch.cumsum(fresh.T.reshape(-1).to(torch.int64), 0)
        over = (fresh.T.reshape(-1) & (order > RESEED_K)).reshape(nx, ny).T
        over = over.contiguous()   # torch.where follows its inputs' layout
        g_sim = _reseed_simultaneous(g, P, F_old, F_new, fluid_new, p)
        g_seq = torch.where(over[None], g_sim, g_seq)
    return g_seq, n_fresh, True


# ───────────────────────── full step ───────────────────────────────────────
def step(state: PulsatileState, t, p: PulsatileParams, dense_mrt=False):
    """One iteration in the reference driver order (:764-791): collide →
    Bouzidi → pull stream → Zou/He → macros → wall move and rebuild."""
    return _step(state, t, p, dense_mrt)[0]


def _step(state: PulsatileState, t, p: PulsatileParams, dense_mrt=False,
          delta=None):
    """``(state, n_fresh, order_dependent)`` after one step; ``delta``: the
    walls' Δ fields when the caller holds them (static walls)."""
    if delta is None:
        delta = border_deltas(state.F, state.yr1, state.yr2, p)
    gout = collide(state, p, dense_mrt)
    gout = bouzidi(gout, state.F, delta, p)
    g = stream_pull(gout)
    g = zou_he(g, state.yr1, state.yr2, t, p)
    P, Ux, Uy = macroscopic(g, state.fluid, p)
    return _finish_step(state, gout, g, P, Ux, Uy, p)


def finish_step(state: PulsatileState, gout, g, P, Ux, Uy,
                p: PulsatileParams):
    """Geometry tail of the step: wall ODE → Fobj → reseeding → macro
    fixups."""
    return _finish_step(state, gout, g, P, Ux, Uy, p)[0]


def _finish_step(state, gout, g, P, Ux, Uy, p: PulsatileParams):
    if not p.deformable:
        return (PulsatileState(gout, g, state.yr1, state.yr2, P, Ux, Uy,
                               state.F, state.fluid), 0, False)
    yr1, yr2 = move_walls(P, state.yr1, state.yr2, p)
    F_new = fobj_from_walls(yr1, yr2, p)
    fluid_new = flags_from_fobj(F_new, p)
    # killed cells keep their streamed populations (they feed the
    # solid-cell aliasing in `collide`)
    g, n_fresh, dep = _reseed(g, P, state.F, F_new, fluid_new, p)
    P_pre, Ux_pre, Uy_pre = P, Ux, Uy
    P, Ux, Uy = macroscopic(g, fluid_new, p)
    # killed cells keep their last fluid macros until the next step's sweep
    killed = state.fluid & (~fluid_new)
    P = torch.where(killed, P_pre, P)
    Ux = torch.where(killed, Ux_pre, Ux)
    Uy = torch.where(killed, Uy_pre, Uy)
    # fresh cells get the FULL first moment (reference
    # Fresh_Macroscopic_Values :492-498), unlike the regular sweep
    fresh = ((state.F[1:-1, 1:-1] < 1.0) & (F_new[1:-1, 1:-1] >= 1.0)
             & fluid_new)
    mom = _dot9(np.asarray(D2Q9.c, dtype=np.float64).T, g)
    Ux = torch.where(fresh, _div(3.0 * mom[0], p.rho0), Ux)
    Uy = torch.where(fresh, _div(3.0 * mom[1], p.rho0), Uy)
    return (PulsatileState(gout, g, yr1, yr2, P, Ux, Uy, F_new, fluid_new),
            n_fresh, dep)


def run(state: PulsatileState, t0, p: PulsatileParams, n_steps: int,
        dense_mrt=False):
    """Advance ``n_steps`` from step index ``t0``; returns the new state
    (``dense_mrt``: see :func:`collide`)."""
    return run_with_diag(state, t0, p, n_steps, dense_mrt)[0]


def run_with_diag(state: PulsatileState, t0, p: PulsatileParams,
                  n_steps: int, dense_mrt=False):
    """``(state, (order_dependent_steps, reseeded_cells))`` over
    ``n_steps`` steps: the counts the CUDA kernel keeps on the device."""
    n_dep = n_cells = 0
    # walls that do not move keep their Δ fields
    delta = (None if p.deformable
             else border_deltas(state.F, state.yr1, state.yr2, p))
    for i in range(n_steps):
        state, n_fresh, dep = _step(state, int(t0) + i, p, dense_mrt, delta)
        n_dep += int(dep)
        n_cells += n_fresh
    return state, (n_dep, n_cells)


# ───────────────────────── initialization ──────────────────────────────────
def _np_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def initialize(p: PulsatileParams, dtype=torch.float64, *,
               device) -> PulsatileState:
    """Theoretical tapered-vessel geometry and parabolic flow (reference
    :174-213, driver :753-757), built in numpy float64 as the JAX version
    builds it, then the pressure-form equilibrium in ``dtype``."""
    nx, ny = p.nx, p.ny
    yc = p.yc
    a = p.alpha

    yr1_in = yc - (p.pin - p.p_tissue) / a
    yr2_in = yc + (p.pin - p.p_tissue) / a
    yr1_out = yc - (p.pout - p.p_tissue) / a
    yr2_out = yc + (p.pout - p.p_tissue) / a
    if yr1_in < 1 or yr2_in > ny - 2 or yr1_out < 1 or yr2_out > ny - 2:
        raise RuntimeError("Initial wall location out of bounds.")
    R0 = (yr2_in - yr1_in) / 2.0
    RL = (yr2_out - yr1_out) / 2.0
    X = np.arange(nx, dtype=np.float64)
    Rx = ((RL ** 4 - R0 ** 4) * (X / (nx - 1)) + R0 ** 4) ** 0.25
    yr1 = yc - Rx
    yr2 = yc + Rx
    P = np.broadcast_to((yr2 - (ny - 1 - 0.5)) * a + p.p_tissue, (ny, nx)).copy()

    F = fobj_from_walls(torch.from_numpy(yr1), torch.from_numpy(yr2),
                        p).numpy()
    fluid = F[1:-1, 1:-1] >= 1.0

    # parabolic Ux from the local dP/dx (:191-204)
    mu = p.rho0 * (p.tau - 0.5) / 3.0
    dpx = np.gradient(P, axis=1)
    dpx[:, 0] = P[:, 1] - P[:, 0]
    dpx[:, -1] = P[:, -1] - P[:, -2]
    Y = np.arange(ny, dtype=np.float64)[:, None]
    inside = (Y >= np.ceil(yr1 - 0.01)[None, :]) & (Y <= np.floor(yr2 + 0.01)[None, :])
    Ux = np.where(inside, dpx / (2 * mu) * (Y - yr1[None, :]) * (Y - yr2[None, :]), 0.0)
    Uy = np.zeros_like(Ux)

    g = pressure_equilibrium(torch.as_tensor(P, dtype=dtype),
                             torch.as_tensor(np.stack([Ux, Uy]), dtype=dtype),
                             p.rho0, D2Q9).numpy()
    g = g * fluid[None]
    npdt = _np_dtype(dtype)

    def dev(x):
        return torch.from_numpy(np.asarray(x).astype(npdt)).to(device)

    ga = dev(g)
    return PulsatileState(
        g_coll=ga,
        # also the first collision input when pingpong is off; fluid-cell
        # g_stream is unread in the parity mode
        g_stream=ga.clone(),
        yr1=dev(yr1), yr2=dev(yr2),
        P=dev(P * fluid), Ux=dev(Ux * fluid), Uy=dev(Uy * fluid),
        F=dev(F), fluid=torch.from_numpy(fluid).to(device))


def initialize_rigid_channel(p: PulsatileParams, yr_bottom: float,
                             yr_top: float, dtype=torch.float64, *,
                             device) -> PulsatileState:
    """Straight rigid channel at fractional wall positions with a linear
    inlet→outlet pressure ramp: the quirk-free validation geometry
    (:mod:`..validation.womersley`), to be run with ``deformable=False``."""
    nx, ny = p.nx, p.ny
    yr1 = torch.full((nx,), yr_bottom, dtype=dtype, device=device)
    yr2 = torch.full((nx,), yr_top, dtype=dtype, device=device)
    F = fobj_from_walls(yr1, yr2, p)
    fluid = flags_from_fobj(F, p)
    ramp = torch.from_numpy(
        np.linspace(p.pin, p.pout, nx).astype(_np_dtype(dtype))).to(device)
    P = ramp.expand(ny, nx) * fluid
    U0 = torch.zeros((ny, nx), dtype=dtype, device=device)
    g = pressure_equilibrium(P, torch.stack([U0, U0]), p.rho0, D2Q9) \
        * fluid[None]
    return PulsatileState(g_coll=g, g_stream=g, yr1=yr1, yr2=yr2,
                          P=P, Ux=U0, Uy=U0, F=F, fluid=fluid)
