"""Reactive multicomponent MRT combustion solver (D2Q9, rest-first
ordering), plain PyTorch.

Port of ``multiphase_lbm_tpu/models/combustion.py`` (reference
``CooLBM_MRT_combustion.cpp`` in its default configuration, the Xu-2018
regeneration channel): four coupled populations, flow f, species
g_O2/g_CO2 (mass fractions) and temperature g_T, on an inflow/outflow
channel with four reactive obstacles; MRT collisions with one relaxation
diagonal per population; the parabolic inlet as moving-wall momentum
exchange at x = 0; the second-order extrapolated flow outlet with its corner
formulas; anti-bounce-back Dirichlet and zero-gradient scalar BCs applied in
the reference's per-cell order; the Arrhenius surface reaction through
interfacial mass fractions; LI2014 conjugate heat transfer; and the
non-default reference flags the JAX model covers (cavity, Couette and
Poiseuille topologies, free-slip walls, the TC corrector, the MRT body
force, the GUO2015 and HUBER2015 schemes).

Every function follows its JAX counterpart op for op, so the two agree to
rounding at float64.  Three rules of the JAX model carry over on purpose:
solid cells hold NaN in their velocity and forcing fields (streaming zeroes
f there, so ρ = 0 and u = 0/0), every mask is applied by selection, never by
multiplication (NaN · 0 is NaN: where the JAX code multiplies by a boolean
array, which JAX evaluates as a selection, the port selects), and every
neighbour read wraps at both edges.  :func:`run` is a Python loop over
:func:`make_step`, the oracle that the CUDA kernel of
:mod:`..ops.combustion_fused` is held against and the path of the
configurations it does not cover.

The static tables stay numpy, as in the JAX model; a step moves each one to
the device of its state once (:func:`_on`).  Functions that create tensors
take an explicit ``device``; the rest run on the device of their inputs.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..core.lattice import D2Q9_REST_FIRST
from ..utils.profiling import upload

LAT = D2Q9_REST_FIRST
Q = 9
C = np.asarray(LAT.c)          # (9, 2) (cx, cy), rest first
W = np.asarray(LAT.w)
OPP = np.asarray(LAT.opp)

# MRT transform of the combustion module (reference :313-336), rest-first
# ordering, applied to rest-first population vectors.
M_MAT = np.array([
    [1, 1, 1, 1, 1, 1, 1, 1, 1],
    [-4, -1, -1, -1, -1, 2, 2, 2, 2],
    [4, -2, -2, -2, -2, 1, 1, 1, 1],
    [0, 1, 0, -1, 0, 1, -1, -1, 1],
    [0, -2, 0, 2, 0, 1, -1, -1, 1],
    [0, 0, 1, 0, -1, 1, 1, -1, -1],
    [0, 0, -2, 0, 2, 1, 1, -1, -1],
    [0, 1, -1, 1, -1, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 1, -1, 1, -1]], dtype=np.float64)
M_INV = np.linalg.inv(M_MAT)


@dataclasses.dataclass(frozen=True)
class CombustionParams:
    """The same fields and defaults as the JAX ``CombustionParams`` (the
    reference's global config block, :52-254)."""

    nx: int = 420
    ny: int = 80
    tau_flow: float = 1.0
    tau_O2: float = 1.021
    tau_CO2: float = 0.973
    tau_T: float = 1.198
    tau_T_solid: float = 0.583
    D_O2: float = 0.1568739
    D_CO2: float = 0.1425984
    cp_gas: float = 356.16739
    cp_solid: float = 235.4266
    rho_gas: float = 1.0
    rho_solid: float = 556.694
    M_O2: float = 32.0
    M_CO2: float = 44.0
    R_id: float = 2701.8026
    A_pre: float = 1.992343666625e5     # Prae_exp_factor
    E_akt: float = 5.511041294e4
    delta_hr: float = 1.8132054257e5
    stoich_O2: float = -1.0
    u_inlet: float = 0.00011741168      # u_lb
    T_inlet: float = 1.0
    Y_O2_inlet: float = 0.22
    Y_CO2_inlet: float = 0.0
    rho_inlet: float = 1.0
    T_ini: float = 1.0
    Y_O2_ini: float = 0.0
    Y_CO2_ini: float = 0.0
    w_e: float = 1.0
    w_eps: float = 1.0
    w_q: float = 1.0
    solid_reaction: bool = True
    conjugate_heat: bool = True          # li2014 on/off
    conj_scheme: str = "li2014"   # "li2014" | "guo2015" | "huber2015" | "none"
    with_obstacles: bool = True
    inlet_parabolic: bool = True
    y_freeslip: bool = False             # specular-reflection y walls
    temperature_coupling: bool = False   # TC=1: C_dach corrector
    T_ref: float = 1.0
    topology: str = "inflow_outflow"     # | "cavity" | "couette" | "poiseuille"
    u_lid: float = 0.0                   # lid/moving-wall speed
    dpdx: float = 0.0                    # body force (poiseuille)
    dpdy: float = 0.0

    @property
    def scheme(self):
        if not self.conjugate_heat and self.conj_scheme == "li2014":
            return "none"
        return self.conj_scheme

    @property
    def sigma(self):
        """(ρ c_p)_solid / (ρ c_p)_gas (reference :106)."""
        return (self.rho_solid * self.cp_solid) / (self.rho_gas * self.cp_gas)

    def S_vectors(self):
        """Per-population MRT relaxation diagonals (reference :340-346)."""
        S = np.array([1, self.w_e, self.w_eps, 1, self.w_q, 1, self.w_q,
                      1 / self.tau_flow, 1 / self.tau_flow])
        SO2 = np.array([1, 1, 1, 1, 1, 1, 1, 1 / self.tau_O2, 1 / self.tau_O2])
        SCO2 = np.array([1, 1, 1, 1, 1, 1, 1, 1 / self.tau_CO2,
                         1 / self.tau_CO2])
        ST = np.full(9, 1 / self.tau_T)
        STs = np.full(9, 1 / self.tau_T_solid)
        return S, SO2, SCO2, ST, STs


# ─── geometry ──────────────────────────────────────────────────────────────
BULK, WALL, SPECULAR, OBSTACLE = 0, 1, 2, 3


def build_geometry(p: CombustionParams):
    """Flags and static momentum-exchange populations per topology
    (reference iniCavity, :3756-4073): inflow/outflow (the parabolic inlet
    as momentum exchange at x = 0, four obstacles), cavity (moving lid),
    Couette (moving top wall, x periodic), Poiseuille (x periodic, body
    force)."""
    ny, nx = p.ny, p.nx
    flags = np.full((ny, nx), BULK, dtype=np.int8)
    f_solid = np.zeros((Q, ny, nx))
    wall_t = SPECULAR if p.y_freeslip else WALL

    if p.topology == "inflow_outflow":
        flags[0, :] = wall_t
        flags[-1, :] = wall_t
        flags[:, 0] = WALL                   # inlet column (momentum exchange)
        flags[0, 0] = WALL
        flags[-1, 0] = WALL
        if p.with_obstacles:
            ys = slice(int(ny * 3.0 / 8.0), int(np.ceil(ny * 5.0 / 8.0)))
            for x0, x1 in ((100, 121), (141, 161), (181, 201), (221, 241)):
                ospec = np.zeros((ny, nx), dtype=bool)
                ospec[ys, x0:x1] = True
                flags[ospec] = OBSTACLE
        # inlet profile (reference :4286-4306)
        yy = np.arange(ny) / (ny - 1.0)
        ux_in = (4.0 * yy * (1.0 - yy) * p.u_inlet if p.inlet_parabolic
                 else np.full(ny, p.u_inlet))
        for k in range(Q):
            f_solid[k, :, 0] = -6.0 * W[k] * 1.0 * (C[k, 0] * ux_in)
        f_solid[:, 0, 0] = 0.0
        f_solid[:, -1, 0] = 0.0
    elif p.topology == "cavity":
        # moving lid at y = ny − 1 (reference :3762-3783)
        flags[0, :] = WALL
        flags[-1, :] = WALL
        flags[:, 0] = WALL
        flags[:, -1] = WALL
        for k in range(Q):
            f_solid[k, -1, :] = -6.0 * W[k] * p.u_lid * C[k, 0]
        f_solid[:, -1, 0] = 0.0
        f_solid[:, -1, -1] = 0.0
    elif p.topology == "couette":
        flags[0, :] = WALL
        flags[-1, :] = WALL
        for k in range(Q):
            f_solid[k, -1, :] = -6.0 * W[k] * p.u_lid * C[k, 0]
    elif p.topology == "poiseuille":
        flags[0, :] = wall_t
        flags[-1, :] = wall_t
    else:
        raise ValueError(p.topology)
    return flags, f_solid


class CombustionState(NamedTuple):
    """The JAX ``CombustionState``'s nine fields, in its order."""
    f: torch.Tensor          # flow
    gO2: torch.Tensor
    gCO2: torch.Tensor
    gT: torch.Tensor
    F_O2_prev: torch.Tensor  # previous forcing terms (temporal derivative)
    F_CO2_prev: torch.Tensor
    F_T_prev: torch.Tensor
    g_coll: torch.Tensor     # LI2014 interface post-collision store
    q_heat: torch.Tensor     # GUO2015 per-cell deposited reaction heat (ny, nx)


def defined_values(state: CombustionState, flags):
    """The first eight fields of ``state`` by name, each over the cells where
    the model defines it: f, g_O2 and g_CO2 over the bulk and obstacle
    cells, the three forcing terms over the bulk cells (u is 0/0 at solid
    cells, so they hold NaN there by design, and no step reads them there),
    g_T and g_coll over every cell.  What a comparison or a finiteness check
    of a state holds."""
    dev = state.f.device
    bulk = torch.as_tensor(flags == BULK, device=dev)
    keep = torch.as_tensor((flags == BULK) | (flags == OBSTACLE), device=dev)
    cells = {"f": keep, "gO2": keep, "gCO2": keep, "F_O2_prev": bulk,
             "F_CO2_prev": bulk, "F_T_prev": bulk}
    return {name: (getattr(state, name)[:, cells[name]] if name in cells
                   else getattr(state, name))
            for name in CombustionState._fields[:8]}


def initialize(p: CombustionParams, dtype=torch.float64, f_restart=None,
               T_solid=None, flags=None, *, device):
    """Reference iniLattice (:535-564): f at rest equilibrium (or the
    restart field), scalars at their initial values; ``T_solid``
    initialises the obstacle temperature separately."""
    ny, nx = p.ny, p.nx
    wk = W[:, None, None]
    f = (np.broadcast_to(wk * p.rho_inlet, (Q, ny, nx)).copy()
         if f_restart is None else np.asarray(f_restart))
    gO2 = np.broadcast_to(wk * p.Y_O2_ini, (Q, ny, nx)).copy()
    gCO2 = np.broadcast_to(wk * p.Y_CO2_ini, (Q, ny, nx)).copy()
    gT = np.broadcast_to(wk * p.T_ini, (Q, ny, nx)).copy()
    if T_solid is not None:
        if flags is None:
            flags, _ = build_geometry(p)
        gT = np.where((flags == OBSTACLE)[None], wk * T_solid, gT)
    z = np.zeros((Q, ny, nx))
    zq = np.zeros((ny, nx))
    npdtype = torch.empty((), dtype=dtype).numpy().dtype
    return CombustionState(*(upload(np.ascontiguousarray(a, dtype=npdtype),
                                    device)
                             for a in (f, gO2, gCO2, gT, z, z, z, z, zq)))


# ─── static link/interface tables ──────────────────────────────────────────
def _shift(a, cx, cy):
    """Value at (y + cy, x + cx), wrapping (callers mask edges)."""
    return np.roll(a, (-cy, -cx), axis=(0, 1)) if a.ndim == 2 else \
        np.roll(a, (-cy, -cx), axis=(1, 2))


def build_static_tables(flags, p: CombustionParams):
    """Per-(cell, k) link classification and interface normal factors.

    The normal-vector classification (reference get_normal_vect,
    :1371-1632) keys on ``erg`` = Σ of the direction indices k whose
    neighbour is a reactive obstacle; for the axis directions the normal is
    −c_k, and the erg tables below transcribe the reference's case analysis
    for the diagonal directions verbatim."""
    ny, nx = flags.shape
    is_bulk = flags == BULK
    is_wall = flags == WALL
    is_spec = flags == SPECULAR
    is_obst = flags == OBSTACLE

    nb_obst = np.zeros((Q, ny, nx), dtype=bool)
    nb_wall = np.zeros((Q, ny, nx), dtype=bool)
    nb_bulk = np.zeros((Q, ny, nx), dtype=bool)
    for k in range(Q):
        cx, cy = int(C[k, 0]), int(C[k, 1])
        nb_obst[k] = _shift(is_obst, cx, cy)
        nb_wall[k] = _shift(is_wall, cx, cy)
        nb_bulk[k] = _shift(is_bulk, cx, cy)

    erg = np.zeros((ny, nx), dtype=np.int32)
    for k in range(Q):
        erg += k * nb_obst[k]

    # erg → normal lookup per diagonal direction; entries guarded on
    # flag(des) use the +x (k = 6) / +y (k = 7) neighbour
    tbl5 = {14: (-1, 0), 13: (0, -1), 23: (0, -1), 22: (-1, -1), 25: (-1, 0),
            5: (-1, -1), 8: (-1, -1), 20: (-1, -1), 17: (-1, -1),
            33: (-1, -1), 35: (0, -1), 32: (-1, -1), 34: (-1, 0)}
    tbl6 = {16: (1, 0), 13: (0, -1), 23: (1, -1), 28: (1, 0), 6: (1, -1),
            11: (1, -1), 17: (1, -1), 33: (0, -1), 35: (1, -1),
            32: (1, -1), 34: (1, 0)}
    tbl6_des = {22: {True: (0, -1), False: (1, -1)}}   # des = +x neighbour
    tbl7 = {19: (0, 1), 16: (1, 0), 28: (1, 1), 25: (0, 1), 7: (1, 1),
            14: (1, 1), 22: (1, 1), 33: (0, 1), 35: (1, 1), 32: (1, 0),
            34: (1, 1)}
    tbl7_des = {23: {True: (1, 0), False: (1, 1)}}     # des = +y neighbour
    tbl8 = {14: (-1, 0), 19: (0, 1), 22: (-1, 0), 28: (0, 1), 25: (-1, 1),
            8: (-1, 1), 13: (-1, 1), 20: (-1, 1), 23: (-1, 1), 33: (-1, 1),
            35: (0, 1), 32: (-1, 0), 34: (-1, 1)}

    ck_n = np.zeros((Q, ny, nx))
    des_x = _shift(is_obst, 1, 0)    # flag at +x neighbour is obstacle
    des_y = _shift(is_obst, 0, 1)
    for k in range(1, Q):
        n = np.zeros((2, ny, nx))
        if k in (1, 2, 3, 4):
            n[0] = -C[k, 0]
            n[1] = -C[k, 1]
        else:
            tbl = {5: tbl5, 6: tbl6, 7: tbl7, 8: tbl8}[k]
            for e, (nxv, nyv) in tbl.items():
                m = erg == e
                n[0][m] = nxv
                n[1][m] = nyv
            if k == 6:
                for e, d in tbl6_des.items():
                    for tv, (nxv, nyv) in d.items():
                        m = (erg == e) & (des_x == tv)
                        n[0][m] = nxv
                        n[1][m] = nyv
            if k == 7:
                for e, d in tbl7_des.items():
                    for tv, (nxv, nyv) in d.items():
                        m = (erg == e) & (des_y == tv)
                        n[0][m] = nxv
                        n[1][m] = nyv
        ck_n[k] = C[k, 0] * n[0] + C[k, 1] * n[1]

    nb_spec = np.zeros((Q, ny, nx), dtype=bool)
    for k in range(Q):
        nb_spec[k] = _shift(is_spec, int(C[k, 0]), int(C[k, 1]))

    # HUBER2015 Karani forcing masks (Temperature_forcing_neu, :968-1019):
    # ∇(1/ρcp) is one-sided and non-zero only at bulk cells with a reactive
    # obstacle on exactly one side per axis; zeroed on the border bands
    # iX ∈ {1, nx−2}, iY ∈ {1, ny−2} (:1007-1019).
    huber_e = is_bulk & nb_obst[1] & ~nb_obst[3]
    huber_w = is_bulk & nb_obst[3] & ~nb_obst[1]
    huber_n = is_bulk & nb_obst[2] & ~nb_obst[4]
    huber_s = is_bulk & nb_obst[4] & ~nb_obst[2]
    ix = np.arange(nx)[None, :]
    iy = np.arange(ny)[:, None]
    huber_border = (ix == 1) | (ix == nx - 2) | (iy == 1) | (iy == ny - 2)
    huber_border = np.broadcast_to(huber_border, (ny, nx))

    return dict(
        is_bulk=is_bulk, is_wall=is_wall, is_spec=is_spec, is_obst=is_obst,
        nb_obst=nb_obst, nb_wall=nb_wall, nb_bulk=nb_bulk, nb_spec=nb_spec,
        ck_n=ck_n, huber_e=huber_e, huber_w=huber_w, huber_n=huber_n,
        huber_s=huber_s, huber_border=huber_border)


def _on(tab, name, device, dtype=None, make=None):
    """``tab[name]`` (or ``make()``, a numpy array derived from the tables)
    as a tensor on ``device``, moved there once and kept in the table."""
    cache = tab.setdefault("_on_device", {})
    key = (name, str(device), dtype)
    t = cache.get(key)
    if t is None:
        a = make() if make is not None else tab[name]
        t = cache[key] = torch.as_tensor(np.array(a), dtype=dtype,
                                         device=device)
    return t


# ─── collision pieces ──────────────────────────────────────────────────────
def _mrt(pop, eq, S):
    """pop − M⁻¹ diag(S) M (pop − eq), over the lattice."""
    A = torch.as_tensor(M_INV @ np.diag(S) @ M_MAT, dtype=pop.dtype,
                        device=pop.device)
    dneq = (pop - eq).reshape(Q, -1)
    return pop - (A @ dneq).reshape(pop.shape)


def _cj(like):
    return torch.as_tensor(C, dtype=like.dtype, device=like.device)


def _wj(like):
    return torch.as_tensor(W, dtype=like.dtype, device=like.device)


def _equilibrium(amp, u, usqr):
    cu = torch.einsum("kd,dyx->kyx", _cj(amp), u)
    return amp[None] * _wj(amp)[:, None, None] * (
        1.0 + 3.0 * cu + 4.5 * cu * cu - usqr[None])


def _central_gradient(q, tab):
    """∂x, ∂y with one-sided second-order differences next to solids
    (reference Mass_fraction_forcing, :643-800); callers zero the
    x-gradient at the outlet."""
    E = torch.roll(q, -1, 1)
    Wq = torch.roll(q, 1, 1)
    Nq = torch.roll(q, -1, 0)
    Sq = torch.roll(q, 1, 0)
    gx = (E - Wq) / 2.0
    gy = (Nq - Sq) / 2.0

    def solid_at(cx, cy):
        return _on(tab, f"solid_at_{cx}_{cy}", q.device,
                   make=lambda: _shift(~tab["is_bulk"], cx, cy))

    s_n, s_s = solid_at(0, 1), solid_at(0, -1)
    s_e, s_w = solid_at(1, 0), solid_at(-1, 0)
    NN = torch.roll(q, -2, 0)
    SS = torch.roll(q, 2, 0)
    EE = torch.roll(q, -2, 1)
    WW = torch.roll(q, 2, 1)
    gy = torch.where(s_s, (-3.0 * q + 4.0 * Nq - NN) / 2.0, gy)
    gy = torch.where(s_n, (3.0 * q - 4.0 * Sq + SS) / 2.0, gy)
    gx = torch.where(s_w, (-3.0 * q + 4.0 * E - EE) / 2.0, gx)
    gx = torch.where(s_e, (3.0 * q - 4.0 * Wq + WW) / 2.0, gx)
    return gx, gy


# ─── macroscopic fields ────────────────────────────────────────────────────
def macro_flow(f):
    rho = f.sum(dim=0)
    mom = torch.einsum("kd,kyx->dyx", _cj(f), f)
    return rho, mom / rho[None]


def macro_scalar(g):
    return g.sum(dim=0)


# ─── boundary-condition phase (writes on incoming populations) ─────────────
def _abb_triplet(g, amp, idx, incoming, axis_col):
    """Anti-bounce-back Dirichlet/zero-gradient fix: for each
    (k_in, k_w, k_out) set g[k_in] = −g[k_out] + 2 w[k_w] amp on the row
    (``axis_col`` 0) or column (1) ``idx``, in order."""
    g = g.clone()
    for k_in, k_w, k_out in incoming:
        src = g[k_out, idx, :] if axis_col == 0 else g[k_out, :, idx]
        val = -src + 2.0 * float(W[k_w]) * amp
        if axis_col == 0:
            g[k_in, idx, :] = val
        else:
            g[k_in, :, idx] = val
    return g


def apply_scalar_bcs(g, amp_inlet, p: CombustionParams, species=False,
                     f_bc=None):
    """Species/temperature BCs (reference Boundaries_Comp /
    Boundaries_Temp_Reaktion, :2092-2360): zero-gradient anti-bounce-back at
    y = 1 and y = ny − 2, Dirichlet at x = 1, zero-gradient at the outlet
    column, in the reference's per-cell order (ascending i = y + ny·x):

    * the top-row extrapolation at x = 1 reads the inlet-fixed rows
      ny − 3 / ny − 4 of column 1, and at x = nx − 1 the outlet-fixed rows
      of column nx − 1;
    * the outlet amplitude is the entry-time extrapolation, on purpose (the
      reference's outlet reads columns nx − 2 / nx − 3, whose row-fixed
      cells are excluded from the outlet mask);
    * for species the outlet zero-gradient excludes rows 1 and ny − 2,
      which take the corner equilibrium scheme with u from the
      outlet-fixed flow ``f_bc``;
    * the temperature outlet applies to every row."""
    ny, nx = g.shape[1:]
    # top wall row ny − 2: extrapolate from below (k 7, 4, 8 ← 5, 2, 6)
    m = macro_scalar(g)
    amp_top = (4.0 * m[ny - 3, :] - m[ny - 4, :]) / 3.0
    # x = 1 override: rows ny − 3 / ny − 4 of column 1 after their inlet fix
    col1 = g[:, :, 1]
    m1_fix = (m[:, 1]
              + sum((-col1[k_out] + 2.0 * float(W[k_w]) * amp_inlet)
                    - col1[k_in]
                    for k_in, k_w, k_out in [(5, 7, 7), (1, 3, 3),
                                             (8, 6, 6)]))
    # x = nx − 1 override: rows of column nx − 1 after their outlet fix;
    # amp_out is the entry-time extrapolation (see the docstring)
    amp_out = (4.0 * m[:, nx - 2] - m[:, nx - 3]) / 3.0
    colo = g[:, :, nx - 1]
    mo_fix = (m[:, nx - 1]
              + sum((-colo[k_out] + 2.0 * float(W[k_w]) * amp_out)
                    - colo[k_in]
                    for k_in, k_w, k_out in [(6, 8, 8), (3, 1, 1),
                                             (7, 5, 5)]))
    amp_top = amp_top.clone()
    amp_top[1] = (4.0 * m1_fix[ny - 3] - m1_fix[ny - 4]) / 3.0
    amp_top[nx - 1] = (4.0 * mo_fix[ny - 3] - mo_fix[ny - 4]) / 3.0
    g = _abb_triplet(g, amp_top, ny - 2,
                     [(7, 7, 5), (4, 2, 2), (8, 6, 6)], 0)
    m = macro_scalar(g)
    amp_bot = (4.0 * m[2, :] - m[3, :]) / 3.0
    g = _abb_triplet(g, amp_bot, 1,
                     [(6, 8, 8), (2, 4, 4), (5, 7, 7)], 0)
    # inlet Dirichlet at x = 1 (k 5, 1, 8 ← 7, 3, 6)
    g = _abb_triplet(g, amp_inlet, 1,
                     [(5, 7, 7), (1, 3, 3), (8, 6, 6)], 1)
    # outlet zero-gradient at x = nx − 1 (k 6, 3, 7 ← 8, 1, 5); species:
    # interior rows only, the corners take the equilibrium scheme below
    rows = torch.arange(ny, device=g.device)
    out_sel = ((rows != 1) & (rows != ny - 2)) if species else \
        torch.ones(ny, dtype=torch.bool, device=g.device)
    g = g.clone()
    for k_in, k_w, k_out in [(6, 8, 8), (3, 1, 1), (7, 5, 5)]:
        val = -g[k_out, :, nx - 1] + 2.0 * float(W[k_w]) * amp_out
        g[k_in, :, nx - 1] = torch.where(out_sel, val, g[k_in, :, nx - 1])
    if species:
        g = _species_outlet_corners(g, f_bc, p)
    return g


def _species_outlet_corners(g, f_bc, p: CombustionParams):
    """Species outlet corner equilibrium scheme (reference Boundaries_Comp
    :2185-2232 bottom, :2236-2275 top): reads the post-row-fix g and the
    outlet-fixed flow ``f_bc`` for u; the non-equilibrium residual GC is
    spread over the five rewritten populations."""
    ny, nx = g.shape[1:]
    g = g.clone()
    for yc, eps_kin, geq_kin, wsum_k in (
            (1, (0, 1, 4, 8), (2, 3, 5, 6, 7), (2, 3, 6, 5, 7)),
            (ny - 2, (0, 1, 2, 5), (3, 4, 6, 7, 8), (3, 4, 6, 7, 8))):
        colc = g[:, yc, nx - 1].clone()
        Yc = colc.sum(dim=0)                     # own macro, post row fix
        # extrapolation neighbours (nx − 2, nx − 3), post their row fix
        Y1 = g[:, yc, nx - 2].sum(dim=0)
        Y2 = g[:, yc, nx - 3].sum(dim=0)
        Y_lok = (4.0 * Y1 - Y2) / 3.0
        fc = f_bc[:, yc, nx - 1]
        rl = fc.sum(dim=0)
        cj = _cj(g)
        uxl = (cj[:, 0] * fc).sum() / rl
        uyl = (cj[:, 1] * fc).sum() / rl
        usqr = 1.5 * (uxl * uxl + uyl * uyl)
        geq = []
        for k in range(Q):
            cu = float(C[k, 0]) * uxl + float(C[k, 1]) * uyl
            geq.append(Yc * float(W[k])
                       * (1.0 + 3.0 * cu + 4.5 * cu * cu - usqr))
        eps = (sum(colc[k] for k in eps_kin)
               + sum(geq[k] for k in geq_kin))
        GC = (Y_lok - eps) / sum(float(W[k]) for k in wsum_k)
        for k in geq_kin:
            g[k, yc, nx - 1] = geq[k] + float(W[k]) * GC
    return g


def apply_flow_outlet(f, p: CombustionParams):
    """Second-order extrapolated flow outlet with non-equilibrium
    reconstruction of f3, f6, f7 and the corner formulas (reference
    Boundaries, :1990-2091)."""
    ny, nx = f.shape[1:]

    def col_macro(col):
        r = col.sum(dim=0)
        mom = torch.einsum("kd,ky->dy", _cj(col), col)
        return r, mom / r[None]

    rho1, u1 = col_macro(f[:, :, nx - 2])
    rho2, u2 = col_macro(f[:, :, nx - 3])
    rho = (4.0 * rho1 - rho2) / 3.0
    ux = (4.0 * u1[0] - u2[0]) / 3.0
    uy = (4.0 * u1[1] - u2[1]) / 3.0
    usqr = ux * ux + uy * uy        # the reference's un-scaled u² here
    feq = []
    for k in range(Q):
        cu = int(C[k, 0]) * ux + int(C[k, 1]) * uy
        feq.append(rho * float(W[k])
                   * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usqr))

    col = f[:, :, nx - 1].clone()
    f3 = feq[3] + 2.0 / 3.0 * rho * ux + 2.0 / 3.0 * (
        feq[3] - col[1] + feq[7] - col[5] + feq[6] - col[8])
    t367 = float(W[3] + W[7] + W[6])
    t76 = float(W[7] + W[6])
    e1 = (rho * ux - col[1] - col[5] - col[8] + feq[6] + feq[3] + feq[7]) / t367
    e2 = (rho * uy - col[2] - col[5] + col[8] + col[4] - feq[6] + feq[7]) / t76
    f6 = feq[6] - float(W[6]) * (e1 - e2)
    f7 = feq[7] - float(W[7]) * (e1 + e2)

    rows = torch.arange(ny, device=f.device)
    interior = (rows > 1) & (rows < ny - 2)
    f = f.clone()
    f[3, :, nx - 1] = torch.where(interior, f3, col[3])
    f[6, :, nx - 1] = torch.where(interior, f6, col[6])
    f[7, :, nx - 1] = torch.where(interior, f7, col[7])

    # corners (reference :2052-2091)
    for yc, sgn in ((1, -1.0), (ny - 2, 1.0)):
        rl, uxl, uyl = rho[yc], ux[yc], uy[yc]
        colc = f[:, yc, nx - 1].clone()
        if sgn < 0:     # bottom corner
            f8 = (rl + rl * uxl - (2.0 / 3.0) * rl * uyl - colc[0]
                  - 2.0 * (colc[1] + colc[4] + colc[8])) / 2.0
        else:           # top corner
            f8 = (rl + rl * uxl + (2.0 / 3.0) * rl * uyl - colc[0]
                  - 2.0 * (colc[1] + colc[2] + colc[5])) / 2.0
        f6c = f8 - rl * uxl / 6.0 + rl * uyl / 6.0
        f3c = colc[1] - 2.0 / 3.0 * rl * uxl
        f7c = colc[5] - rl * uxl / 6.0 + rl * uyl / 6.0
        f[8, yc, nx - 1] = f8
        f[6, yc, nx - 1] = f6c
        f[3, yc, nx - 1] = f3c
        f[7, yc, nx - 1] = f7c
        if sgn < 0:
            f[2, yc, nx - 1] = colc[4] + 2.0 / 3.0 * rl * uyl
        else:
            f[4, yc, nx - 1] = colc[2] - 2.0 / 3.0 * rl * uyl
    return f


def apply_conjugate_bc(gT, g_coll, tab, p: CombustionParams):
    """LI2014 conjugate interface fix on incoming T populations (reference
    Boundaries_Temp_Solid, :2361-2377): for each solid cell i with bulk
    neighbour nb = i + c_k,
      gin_T(i, opp k) = −((1−Σ)/(1+Σ)) g_coll(i,k) + (2/(1+Σ)) g_coll(nb, opp k)
      gin_T(nb, k)    =  ((1−Σ)/(1+Σ)) g_coll(nb, opp k) + (2Σ/(1+Σ)) g_coll(i,k)
    """
    sig = p.sigma
    a = (1.0 - sig) / (1.0 + sig)
    b2 = 2.0 / (1.0 + sig)
    c2 = 2.0 * sig / (1.0 + sig)
    dev = gT.device
    is_obst = _on(tab, "is_obst", dev)
    is_bulk = _on(tab, "is_bulk", dev)
    nb_bulk = _on(tab, "nb_bulk", dev)
    gT = gT.clone()
    for k in range(1, Q):
        cx, cy = int(C[k, 0]), int(C[k, 1])
        ko = int(OPP[k])
        # solid cells with a bulk neighbour in +k
        link_solid = is_obst & nb_bulk[k]
        gcoll_nb_opp = torch.roll(g_coll[ko], (-cy, -cx), dims=(0, 1))
        gT[ko] = torch.where(link_solid, -a * g_coll[k] + b2 * gcoll_nb_opp,
                             gT[ko])
        # the paired write at the gas node nb (direction k), at nb's
        # coordinates: gas cells with an obstacle neighbour in −k
        gas_link = is_bulk & torch.roll(is_obst, (cy, cx), dims=(0, 1))
        gcoll_solid_k = torch.roll(g_coll[k], (cy, cx), dims=(0, 1))
        gT[k] = torch.where(gas_link, a * g_coll[ko] + c2 * gcoll_solid_k,
                            gT[k])
    return gT


# ─── reaction ──────────────────────────────────────────────────────────────
def _arrhenius(T, p: CombustionParams):
    # floor T: wall and solid rows can carry values where exp(−E/RT)
    # overflows for T → 0⁻
    return p.A_pre * torch.exp(-p.E_akt / (p.R_id * torch.clamp_min(T, 1e-2)))


def interface_mass_fractions(T, YO2, YCO2, tab, p: CombustionParams):
    """Y at the reactive interface per direction (reference
    Reaction_Interface, :1633-1652), at every cell (the obstacle-link
    selections downstream keep the gas cells')."""
    kr = _arrhenius(T, p)
    ck_n = _on(tab, "ck_n", T.device, T.dtype)
    YO2_int = []
    YCO2_int = []
    for k in range(Q):
        denom = p.D_O2 + 0.5 * ck_n[k] * p.stoich_O2 * kr
        yo = p.D_O2 * YO2 / denom
        yc = YCO2 - (0.5 * ck_n[k] * kr * yo * p.M_CO2) / (p.D_CO2 * p.M_O2)
        YO2_int.append(yo)
        YCO2_int.append(yc)
    return torch.stack(YO2_int), torch.stack(YCO2_int)


# ─── streaming ─────────────────────────────────────────────────────────────
def _pull(post, k):
    cx, cy = int(C[k, 0]), int(C[k, 1])
    return torch.roll(post[k], (cy, cx), dims=(0, 1))


# specular mirror pairs (rest-first ordering): flip cy
_YFLIP = {1: 1, 2: 4, 3: 3, 4: 2, 5: 8, 6: 7, 7: 6, 8: 5}


def stream_flow(post, f_solid, tab):
    """Flow streaming: bounce-back with momentum exchange at walls and
    obstacles (reference stream/streamFlow :1679-1769); specular reflection
    at free-slip walls (reference Specular :1330-1370).  Non-bulk outputs
    are zeroed by selection."""
    dev = post.device
    nb_obst = _on(tab, "nb_obst", dev)
    nb_wall = _on(tab, "nb_wall", dev)
    f_solid = np.asarray(f_solid)
    has_spec = bool(tab["is_spec"].any())
    out = [post[0]]
    for k in range(1, Q):
        ko = int(OPP[k])
        # bounce-back at cell j for direction k comes from j's own link in
        # direction opp k hitting a solid nb = j + c_{opp k}:
        #   fout(j, k) = post(j, opp k) + f_solid(nb, opp k)
        nb_solid = nb_obst[ko] | nb_wall[ko]
        fs_nb = torch.as_tensor(
            _shift(f_solid[ko], int(C[ko, 0]), int(C[ko, 1])),
            dtype=post.dtype, device=dev)
        val = torch.where(nb_solid, post[ko] + fs_nb, _pull(post, k))
        # specular: fout(j, k) = post(j − (cx_k, 0), yflip(k)) where the
        # wall row beyond j against c_k's y-component is specular and the
        # reflecting sender is a bulk cell
        ksrc = _YFLIP[k]
        cxk, cyk = int(C[k, 0]), int(C[k, 1])
        if cyk != 0 and has_spec:
            spec_at = torch.as_tensor(
                _shift(tab["is_spec"], 0, -cyk)
                & _shift(tab["is_bulk"], -cxk, 0), device=dev)
            mirrored = torch.roll(post[ksrc], (0, cxk), dims=(0, 1))
            val = torch.where(spec_at, mirrored, val)
        out.append(val)
    res = torch.stack(out)
    # selection, not multiplication: solid-cell values can be NaN
    return torch.where(_on(tab, "is_bulk", dev)[None], res, 0.0)


def stream_species(post, Y_int_k, tab, p: CombustionParams):
    """Species streaming: plain bounce-back at walls; anti-bounce-back
    Dirichlet with the interfacial mass fraction at obstacle links
    (reference streamKonz, :1770-1838)."""
    dev = post.device
    nb_obst_t = _on(tab, "nb_obst", dev)
    nb_wall_t = _on(tab, "nb_wall", dev)
    out = [post[0]]
    for k in range(1, Q):
        ko = int(OPP[k])
        pulled = _pull(post, k)
        bb = post[ko]
        abb = -post[ko] + 2.0 * float(W[ko]) * Y_int_k[ko]
        val = torch.where(nb_wall_t[ko], bb, pulled)
        if p.solid_reaction:
            val = torch.where(nb_obst_t[ko], abb, val)
        else:
            val = torch.where(nb_obst_t[ko], bb, val)
        out.append(val)
    res = torch.stack(out)
    # selection, not multiplication: solid-cell values can be NaN
    return torch.where(_on(tab, "is_bulk", dev)[None], res, 0.0)


def stream_temperature(post_gas, post_solid, gT_old, tab, p: CombustionParams):
    """Temperature streaming across gas and solid (reference streamTemp
    :1839-1934, streamTemp_solid :1935-1970): interface links are not
    streamed (their post-collision values go to g_coll; the conjugate BC
    fills the incoming entries next step, and the old values stay, as the
    reference's unwritten buffer entries do).  In the inflow/outflow
    channel a bulk cell's wall-originating populations keep this step's
    BC-fixed values (streamTemp has no wall bounce-back there)."""
    dev = post_gas.device
    is_bulk = _on(tab, "is_bulk", dev)
    is_obst = _on(tab, "is_obst", dev)
    nb_obst = _on(tab, "nb_obst", dev)
    nb_bulk = _on(tab, "nb_bulk", dev)
    nb_wall = _on(tab, "nb_wall", dev)
    post = torch.where(is_bulk[None], post_gas, post_solid)
    g_coll_new = torch.zeros_like(post_gas)
    out = [post[0]]
    for k in range(1, Q):
        ko = int(OPP[k])
        cx, cy = int(C[k, 0]), int(C[k, 1])
        pulled = _pull(post, k)
        # links whose upstream j − c_k is across a gas/solid interface
        up_is_obst = torch.roll(is_obst, (cy, cx), dims=(0, 1))
        up_is_bulk = torch.roll(is_bulk, (cy, cx), dims=(0, 1))
        iface = (up_is_obst & is_bulk) | (up_is_bulk & is_obst)
        if p.scheme == "li2014":
            val = torch.where(iface, gT_old[k], pulled)
        else:
            # GUO2015 / none: populations pass through the interface
            val = pulled
        if p.topology == "inflow_outflow":
            val = torch.where(nb_wall[ko], gT_old[k], val)
        out.append(val)
        # store post-collision populations pointing across the interface
        sender_iface = (is_bulk & nb_obst[k]) | (is_obst & nb_bulk[k])
        g_coll_new[k] = torch.where(sender_iface, post[k], 0.0)
    return torch.stack(out), g_coll_new


# ─── full step ─────────────────────────────────────────────────────────────
def make_step(p: CombustionParams, flags=None, f_solid=None, konv=True,
              first_step=False):
    """``(step, tab)``: the step function for a static geometry and its
    tables; ``step(state)`` runs on the device of ``state``."""
    if flags is None:
        flags, f_solid = build_geometry(p)
    tab = build_static_tables(flags, p)
    S, SO2, SCO2, ST, STs = p.S_vectors()
    io = p.topology == "inflow_outflow"

    def step(state: CombustionState):
        f, gO2, gCO2, gT = state.f, state.gO2, state.gCO2, state.gT
        dev, dt = f.device, f.dtype
        is_bulk = _on(tab, "is_bulk", dev)
        is_obst = _on(tab, "is_obst", dev)
        nb_obst = _on(tab, "nb_obst", dev)

        # ── phase 1: BC fixes on incoming populations ──
        if io:
            f = apply_flow_outlet(f, p)
        if konv:
            if io:
                gO2 = apply_scalar_bcs(gO2, p.Y_O2_inlet, p, species=True,
                                       f_bc=f)
                gCO2 = apply_scalar_bcs(gCO2, p.Y_CO2_inlet, p, species=True,
                                        f_bc=f)
                gT = apply_scalar_bcs(gT, p.T_inlet, p)
            if p.scheme == "li2014" and not first_step:
                gT = apply_conjugate_bc(gT, state.g_coll, tab, p)
            if p.scheme == "guo2015" and p.solid_reaction:
                # Reaktion_Solid (:2378-2388): deposit the accumulated
                # reaction heat into the solid populations
                dep = torch.where(is_obst[None],
                                  _wj(gT)[:, None, None] * state.q_heat[None],
                                  0.0)
                gT = gT + dep

        # ── phase 2: macro ──
        rho, u = macro_flow(f)
        if p.dpdx or p.dpdy:
            # half-force velocity shift (reference macro, :580)
            u = u + torch.stack([torch.full_like(rho, p.dpdx / 2.0),
                                 torch.full_like(rho, p.dpdy / 2.0)]) / rho[None]
        usqr = 1.5 * (u[0] ** 2 + u[1] ** 2)
        YO2 = macro_scalar(gO2)
        YCO2 = macro_scalar(gCO2)
        T = macro_scalar(gT)

        # ── phase 3: collisions ──
        feq = _equilibrium(rho, u, usqr)
        post_f = _mrt(f, feq, S)
        cj, wj = _cj(f), _wj(f)
        if p.dpdx or p.dpdy:
            # MRT external force (reference collideMRT, :2451-2475), moments
            # relaxed by (1 − S/2)
            cu_f = torch.einsum("kd,dyx->kyx", cj, u)
            cF = (cj[:, 0][:, None, None] * p.dpdx
                  + cj[:, 1][:, None, None] * p.dpdy)
            uF = u[0] * p.dpdx + u[1] * p.dpdy
            Fk = wj[:, None, None] * (3.0 * cF + 9.0 * cu_f * cF
                                      - 3.0 * uF[None])
            Mj = torch.as_tensor(M_MAT, dtype=dt, device=dev)
            Minv_j = torch.as_tensor(M_INV, dtype=dt, device=dev)
            Sv = torch.as_tensor(S, dtype=dt, device=dev)
            mF = torch.einsum("kj,jyx->kyx", Mj, Fk)
            mF = mF * (1.0 - 0.5 * Sv)[:, None, None]
            post_f = post_f + torch.einsum("kj,jyx->kyx", Minv_j, mF)
        if p.temperature_coupling:
            # TC = 1 corrector C_dach (reference :2596-2665)
            theta = macro_scalar(gT) / p.T_ref
            Qx = rho * u[0] * (1.0 - theta - u[0] ** 2)
            Qy = rho * u[1] * (1.0 - theta - u[1] ** 2)
            dQx, _ = _central_gradient(Qx, tab)
            _, dQy = _central_gradient(Qy, tab)
            last_col = (torch.arange(p.nx, device=dev) == p.nx - 1)[None, :]
            dQx = torch.where(last_col, 0.0, dQx)
            s_tc = dQx + dQy
            Cm = torch.zeros((Q,) + tuple(s_tc.shape), dtype=dt, device=dev)
            Cm[1] = 3.0 * s_tc
            Cm[2] = -3.0 * s_tc
            Cm[7] = dQx - dQy
            Sv = torch.as_tensor(S, dtype=dt, device=dev)
            Cm = Cm * (1.0 - 0.5 * Sv)[:, None, None]
            Minv_j = torch.as_tensor(M_INV, dtype=dt, device=dev)
            post_f = post_f + torch.einsum("kj,jyx->kyx", Minv_j, Cm)

        q_new = state.q_heat
        if konv:
            # species with thermal-expansion forcing (:643-800, :2680-2769)
            grho_x, grho_y = _central_gradient(rho, tab)
            gux, _ = _central_gradient(u[0], tab)
            _, guy = _central_gradient(u[1], tab)
            gY1x, gY1y = _central_gradient(YO2, tab)
            gY2x, gY2y = _central_gradient(YCO2, tab)
            # outlet column: zero x-gradients (:755-760)
            outlet = (torch.arange(p.nx, device=dev) == p.nx - 1)[None, :]
            gY1x = torch.where(outlet, 0.0, gY1x)
            gY2x = torch.where(outlet, 0.0, gY2x)
            gux = torch.where(outlet, 0.0, gux)
            div_u = gux + guy
            F_O2 = (p.D_O2 / rho) * (gY1x * grho_x + gY1y * grho_y) + YO2 * div_u
            F_CO2 = (p.D_CO2 / rho) * (gY2x * grho_x + gY2y * grho_y) \
                + YCO2 * div_u

            cu = torch.einsum("kd,dyx->kyx", cj, u)
            w3 = wj[:, None, None]
            FO2_k = w3 * F_O2[None] * (
                1.0 + 3.0 * cu * ((p.tau_O2 - 0.5) / p.tau_O2))
            FCO2_k = w3 * F_CO2[None] * (
                1.0 + 3.0 * cu * ((p.tau_CO2 - 0.5) / p.tau_CO2))

            geqO2 = _equilibrium(YO2, u, usqr)
            geqCO2 = _equilibrium(YCO2, u, usqr)
            post_O2 = (_mrt(gO2, geqO2, SO2) + FO2_k
                       + 0.5 * (FO2_k - state.F_O2_prev))
            post_CO2 = (_mrt(gCO2, geqCO2, SCO2) + FCO2_k
                        + 0.5 * (FCO2_k - state.F_CO2_prev))

            # temperature with reaction heat release (:2770-2892)
            YO2_int, YCO2_int = interface_mass_fractions(T, YO2, YCO2, tab, p)
            # only the axis directions k = 1..4 whose neighbour is an
            # obstacle contribute (reference :2824)
            y_sum = torch.zeros_like(T)
            for k in (1, 2, 3, 4):
                y_sum = y_sum + torch.where(nb_obst[k], YO2_int[k], 0.0)
            if p.scheme == "guo2015":
                # GUO2015 (:2826-2856): no gas-side heating; per-direction
                # reaction rates deposit into the adjacent cells' q store
                F_T = torch.zeros_like(T)
                kr = _arrhenius(T, p)
                q_new = torch.zeros_like(T)
                for k in (1, 2, 3, 4):
                    frk = kr * torch.where(nb_obst[k] & is_bulk,
                                           YO2_int[k], 0.0) * rho / p.M_O2
                    fq = frk * p.delta_hr / (p.rho_solid * p.cp_solid)
                    cx, cy = int(C[k, 0]), int(C[k, 1])
                    # deposit at the neighbour in direction k (scatter → pull)
                    q_new = q_new + torch.roll(fq, (cy, cx), dims=(0, 1))
            elif p.scheme in ("li2014", "huber2015"):
                # F_Q1 enters the gas only under HUBER2015 || LI2014 (:2861)
                F_r = _arrhenius(T, p) * y_sum * rho / p.M_O2
                F_T = F_r * p.delta_hr / (rho * p.cp_gas)
            else:  # scheme "none": passthrough streaming, no gas-side heat
                F_T = torch.zeros_like(T)
            geqT = _equilibrium(T, u, usqr)
            if p.scheme == "huber2015":
                # Karani-2015 conjugate forcing (Temperature_forcing_neu,
                # :907-1025): F = q·∇(1/ρcp), q from the local
                # non-equilibrium first moment, one-sided half-cell
                # ∇(1/ρcp) at gas/solid interfaces
                u_b = torch.where(is_bulk[None], u, 0.0)
                rho_b = torch.where(is_bulk, rho, 1.0)
                fac = 1.0 - 1.0 / (2.0 * p.tau_T)
                cu_b = torch.einsum("kd,dyx->kyx", cj, u_b)
                dneq = gT - T[None] * w3 * (
                    1.0 + 3.0 * cu_b + 4.5 * cu_b ** 2
                    - 1.5 * (u_b[0] ** 2 + u_b[1] ** 2))
                mom = torch.einsum("kd,kyx->dyx", cj, dneq)
                rc_loc = rho_b * p.cp_gas
                qx = rc_loc * (fac * mom[0] + u_b[0] * T)
                qy = rc_loc * (fac * mom[1] + u_b[1] * T)
                rc_avg = (rc_loc + p.rho_solid * p.cp_solid) / 2.0
                step_g = (1.0 / rc_avg - 1.0 / rc_loc) / 0.5   # Δx/2, Δx = 1
                Gx = (torch.where(_on(tab, "huber_e", dev), step_g, 0.0)
                      - torch.where(_on(tab, "huber_w", dev), step_g, 0.0))
                Gy = (torch.where(_on(tab, "huber_n", dev), step_g, 0.0)
                      - torch.where(_on(tab, "huber_s", dev), step_g, 0.0))
                ok = is_bulk & ~_on(tab, "huber_border", dev)
                F_T = F_T + torch.where(ok, qx * Gx + qy * Gy, 0.0)
            FT_k = w3 * F_T[None] * (
                1.0 + 3.0 * cu * ((p.tau_T - 0.5) / p.tau_T))
            post_T = (_mrt(gT, geqT, ST) + FT_k
                      + 0.5 * (FT_k - state.F_T_prev))
            # solid temperature (rest-frame equilibrium, :2958-3017)
            geqT_s = T[None] * w3
            post_T_solid = _mrt(gT, geqT_s, STs)
        else:
            post_O2, post_CO2 = gO2, gCO2
            FO2_k = state.F_O2_prev
            FCO2_k = state.F_CO2_prev
            FT_k = state.F_T_prev

        # ── phase 4: streaming ──
        f2 = stream_flow(post_f, f_solid, tab)
        if konv:
            gO2_2 = stream_species(post_O2, YO2_int, tab, p)
            gCO2_2 = stream_species(post_CO2, YCO2_int, tab, p)
            gT_2, g_coll = stream_temperature(post_T, post_T_solid, gT, tab, p)
        else:
            gO2_2, gCO2_2, gT_2, g_coll = gO2, gCO2, gT, state.g_coll

        if io:
            # the reference's push stream never writes the west-pointing
            # populations {3, 6, 7} of column nx − 1: pin them to this
            # step's BC outputs (see the JAX model and PARITY.md)
            wp = torch.tensor([3, 6, 7], device=dev)
            blk = is_bulk[None, :, -1]
            pinned = []
            for arr2, bc_arr in ((f2, f), (gO2_2, gO2), (gCO2_2, gCO2),
                                 (gT_2, gT)):
                arr2 = arr2.clone()
                arr2[wp, :, -1] = torch.where(blk, bc_arr[wp, :, -1],
                                              arr2[wp, :, -1])
                pinned.append(arr2)
            f2, gO2_2, gCO2_2, gT_2 = pinned

        return CombustionState(f2, gO2_2, gCO2_2, gT_2,
                               FO2_k, FCO2_k, FT_k, g_coll, q_new)

    return step, tab


def run(state: CombustionState, p: CombustionParams, n_steps: int,
        konv: bool = True, first_step: bool = False):
    """``n_steps`` steps; with ``first_step`` the first of them skips the
    LI2014 conjugate fix (the conjugate store is not populated yet) and the
    rest run the steady-state step, as the JAX ``run`` does."""
    if first_step and n_steps > 0:
        step_first, _ = make_step(p, konv=konv, first_step=True)
        state = step_first(state)
        n_steps -= 1
    step, _ = make_step(p, konv=konv, first_step=False)
    for _ in range(n_steps):
        state = step(state)
    return state


# ─── diagnostics ───────────────────────────────────────────────────────────
def kinetic_energy(state, tab):
    rho, u = macro_flow(state.f)
    m = _on(tab, "is_bulk", state.f.device)
    e = (torch.where(m[None], u, 0.0) ** 2).sum()
    return 0.5 * e / m.numel()


def thermal_energy(state, tab, p: CombustionParams):
    """Σ ρ c_p T over bulk and obstacle cells (reference total_Energy,
    :3331-3355)."""
    dev = state.f.device
    T = macro_scalar(state.gT)
    rho, _ = macro_flow(state.f)
    rc = torch.where(_on(tab, "is_obst", dev),
                     p.rho_solid * p.cp_solid, rho * p.cp_gas)
    m = _on(tab, "is_bulk", dev) | _on(tab, "is_obst", dev)
    return torch.where(m, rc * T, 0.0).sum()


def mass_flux_audit(state, tab, p: CombustionParams):
    """Inlet/outlet mass-flux totals (reference Conservation_check_output,
    :3179-3330, reduced to the headline totals).  The JAX model multiplies
    by the bulk mask, which JAX evaluates as a selection (NaN · False is 0
    there); the port selects."""
    rho, u = macro_flow(state.f)
    bulk = _on(tab, "is_bulk", state.f.device)
    flux = rho * u[0]
    inflow = torch.where(bulk[:, 1], flux[:, 1], 0.0).sum()
    outflow = torch.where(bulk[:, -1], flux[:, -1], 0.0).sum()
    return inflow, outflow


def run_staged(state: CombustionState, p: CombustionParams,
               max_flow_steps: int = 100000, check_every: int = 500,
               tol: float = 1e-5, n_consecutive: int = 4,
               scalar_steps: int = 0, log=None, runner=None):
    """Two-stage convergence-gated run (reference :4394-4412): advance the
    flow alone until the kinetic energy deviates < tol for
    ``n_consecutive`` consecutive checks, then enable species and
    temperature transport.  ``runner`` advances the state with the
    signature of :func:`run` (default :func:`run`; ``run_combustion``
    passes the kernel's wrapper)."""
    runner = runner or run
    _, tab = make_step(p, konv=False)
    e_prev = float(kinetic_energy(state, tab))
    hits = 0
    done = 0
    while done < max_flow_steps:
        state = runner(state, p, check_every, konv=False)
        done += check_every
        e = float(kinetic_energy(state, tab))
        dev = abs(e - e_prev) / max(abs(e), 1e-300)
        if log:
            log(done, e, dev)
        hits = hits + 1 if dev < tol else 0
        e_prev = e
        if hits >= n_consecutive:
            break
    if scalar_steps > 0:
        state = runner(state, p, 1, konv=True, first_step=True)
        state = runner(state, p, scalar_steps - 1, konv=True)
    return state, done


# ─── profile / slice outputs (reference :3456-3532, :3356-3459) ────────────
def _host(t):
    return t.detach().cpu().numpy()


def save_profiles(outdir, state, tab, p: CombustionParams, ulb=None):
    """Centerline velocity profiles middlex.dat / middley.dat (reference
    saveProfiles)."""
    ulb = ulb or p.u_inlet
    rho, u = macro_flow(state.f)
    ux = _host(u[0])
    uy = _host(u[1])
    bulkish = ~tab["is_wall"]
    ny, nx = p.ny, p.nx
    y1 = ny // 2 - (1 if ny % 2 == 0 else 0)
    y2 = ny // 2
    x1 = nx // 2 - (1 if nx % 2 == 0 else 0)
    x2 = nx // 2
    with open(Path(outdir) / "middlex.dat", "w") as fh:
        for iX in range(1, nx - 1):
            if bulkish[y1, iX] and bulkish[y2, iX]:
                pos = (iX - 0.5) / (nx - 2) * 2.0 - 1.0
                fh.write(f"{pos:20.8g}{0.5 * (ux[y1, iX] + ux[y2, iX]) / ulb:20.8g}"
                         f"{0.5 * (uy[y1, iX] + uy[y2, iX]) / ulb:20.8g}\n")
    with open(Path(outdir) / "middley.dat", "w") as fh:
        for iY in range(1, ny - 1):
            if bulkish[iY, x1] and bulkish[iY, x2]:
                pos = (iY - 0.5) / (ny - 2) * 2.0 - 1.0
                fh.write(f"{pos:20.8g}{0.5 * (ux[iY, x1] + ux[iY, x2]) / ulb:20.8g}"
                         f"{0.5 * (uy[iY, x1] + uy[iY, x2]) / ulb:20.8g}\n")


def save_slice(outdir, state, p: CombustionParams):
    """Full-field vx/vy/|v|/rho text dumps (reference saveSlice,
    :3503-3532)."""
    rho, u = macro_flow(state.f)
    ux, uy = _host(u[0]), _host(u[1])
    r = _host(rho)
    for name, arr in (("vx.dat", ux), ("vy.dat", uy),
                      ("v.dat", np.sqrt(ux * ux + uy * uy)), ("rho.dat", r)):
        np.savetxt(Path(outdir) / name, arr, fmt="%.8g")


def middleline(outdir, state, tab, p: CombustionParams, t_ph=0.0,
               inflow_ux=None):
    """Centerline profile dump at a fixed physical time (reference
    Middleline, :3356-3459): ``velocity_middleline_<t>.dat`` with columns
    pos, ux, uy, T, Y_O2, Y_CO2 averaged over the two center rows; x = 0
    reports the imposed inlet state, non-bulk centerline cells report 0."""
    ny, nx = p.ny, p.nx
    y1 = ny // 2 - (1 if ny % 2 == 0 else 0)
    y2 = ny // 2
    rho, u = macro_flow(state.f)
    ux = _host(u[0])
    uy = _host(u[1])
    T = _host(macro_scalar(state.gT))
    Y1 = _host(macro_scalar(state.gO2))
    Y2 = _host(macro_scalar(state.gCO2))
    bulk = tab["is_bulk"]
    if inflow_ux is None:
        yy = np.arange(ny) / (ny - 1.0)
        inflow_ux = (4.0 * yy * (1.0 - yy) * p.u_inlet if p.inlet_parabolic
                     else np.full(ny, p.u_inlet))
    # the reference's file name: setfill('0') << setw(7) << time with the
    # default 6-digit stream precision
    name = f"velocity_middleline_{t_ph:07.6g}.dat"
    width = float(nx - 2)
    with open(Path(outdir) / name, "w") as fh:
        for iX in range(nx):
            if iX == 0:
                vx = 0.5 * (inflow_ux[y1] + inflow_ux[y2])
                vy = 0.0
                Tl, Yo, Yc = p.T_inlet, p.Y_O2_inlet, p.Y_CO2_inlet
            else:
                ok = bulk[y1, iX] and bulk[y2, iX]
                vx = 0.5 * (ux[y1, iX] + ux[y2, iX]) if ok else 0.0
                vy = 0.5 * (uy[y1, iX] + uy[y2, iX]) if ok else 0.0
                Yo = 0.5 * (Y1[y1, iX] + Y1[y2, iX]) if ok else 0.0
                Yc = 0.5 * (Y2[y1, iX] + Y2[y2, iX]) if ok else 0.0
                Tl = 0.5 * (T[y1, iX] + T[y2, iX])
            pos = (iX - 0.5) / width * 2.0 - 1.0
            fh.write(f"{pos:20.8g}{vx:20.8g}{vy:20.8g}"
                     f"{Tl:20.8g}{Yo:20.8g}{Yc:20.8g}\n")


def conservation_audit(outdir, state, tab, p: CombustionParams):
    """Per-row inlet/outlet mass and momentum fluxes, species fluxes at
    both stations, and the flux-balance totals: the reference's nine audit
    files (Conservation_check_output, :3179-3330)."""
    out = Path(outdir)
    rho, u = macro_flow(state.f)
    r = _host(rho)
    ux = _host(u[0])
    uy = _host(u[1])
    YO2 = _host(macro_scalar(state.gO2))
    YCO2 = _host(macro_scalar(state.gCO2))
    ny, nx = p.ny, p.nx
    x1, x2 = 1, nx - 1
    rows = np.arange(1, ny - 1)
    width = float(ny - 2)
    pos = (rows - 0.5) / width * 2.0 - 1.0

    def rowfile(name, legend_cols, cols):
        with open(out / f"{name}_names.dat", "w") as fh:
            fh.write("".join(f"{c:>40s}" for c in legend_cols) + "\n")
        np.savetxt(out / f"{name}.dat", np.column_stack(cols), fmt="%20.8g")

    for col, station in ((x1, "inlet"), (x2, "outlet")):
        rowfile(f"{station}_massflow",
                ["Lattice-Number-in-Y-direction", "Position",
                 f"Mass-flow-x-direction-{station}-[mlu/tlu]",
                 f"Mass-flow-y-direction-{station}-[mlu/tlu]"],
                [rows, pos, (r * ux)[1:-1, col], (r * uy)[1:-1, col]])
        rowfile(f"{station}_momentumflow",
                ["Lattice-Number-in-Y-direction", "Position",
                 f"momentum-flow-x-direction-{station}-[mlu/tlu]",
                 f"momentum-flow-y-direction-{station}-[mlu/tlu]"],
                [rows, pos, (r * ux * ux)[1:-1, col],
                 (r * uy * uy)[1:-1, col]])
    # species mass flow at both stations in one file (reference
    # massflow_Komp_inlet_outlet.dat)
    with open(out / "massflow_Komp_inlet_outlet_names.dat", "w") as fh:
        fh.write("iY pos O2_inlet O2_outlet CO2_inlet CO2_outlet\n")
    np.savetxt(out / "massflow_Komp_inlet_outlet.dat", np.column_stack(
        [rows, pos,
         (r * ux * YO2)[1:-1, x1], (r * ux * YO2)[1:-1, x2],
         (r * ux * YCO2)[1:-1, x1], (r * ux * YCO2)[1:-1, x2]]),
        fmt="%20.8g")
    fin, fout = mass_flux_audit(state, tab, p)
    with open(out / "conservation_totals.dat", "w") as fh:
        fh.write(f"{float(fin):.12g} {float(fout):.12g}\n")
