"""Conservative phase-field LBM (Fakhari et al. 2017), velocity-based hydro,
plain PyTorch.

Port of ``multiphase_lbm_tpu/models/fakhari.py`` (reference
``Abbashub LBM/apps/Young_Laplace2D.h``): two D2Q9 distributions — h̄ (phase
field φ) and ḡ (normalised pressure p*) — with BGK collision, interface
sharpening force F^φ, and total hydrodynamic force F = μ_φ∇φ + F_p + F_μ,
on a fully periodic lattice.

The state is the triple ``(h, g, u)``; every other field is derived from
``(h, g)`` each step.  The velocity update uses the *previous* step's u
inside the non-equilibrium stress, as the reference does (it reads the
stale ``Ux/Uy`` members before overwriting them, Young_Laplace2D.h:353-368).
:func:`run` is a Python loop over :func:`step`, the oracle that the CUDA
kernel of :mod:`..ops.fakhari_fused` is held against.

Functions that create tensors take an explicit ``device``; the rest run on
the device of their inputs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.collision import gamma_minus_w, lattice_tensors
from ..core.lattice import D2Q9, Lattice
from ..core.stencil import isotropic_gradient, lattice_laplacian
from ..core.streaming import stream_periodic

EPS_C = 1e-30   # reference epsC, Young_Laplace2D.h:100


@dataclasses.dataclass(frozen=True)
class FakhariParams:
    """The same fields and defaults as the JAX ``FakhariParams``
    (Young_Laplace2D.h:85-96, ``configs/young_laplace2D.txt``)."""

    rhol: float = 0.001     # light density ρ_L
    rhoh: float = 1.0       # heavy density ρ_H
    sigma: float = 0.01     # surface tension σ
    W: float = 4.0          # interface width ξ
    M: float = 0.02         # mobility
    tau: float = 0.8        # hydrodynamic relaxation

    @property
    def s8(self):
        return 1.0 / self.tau

    @property
    def beta(self):
        return 12.0 * self.sigma / self.W      # :95

    @property
    def kappa(self):
        return 1.5 * self.sigma * self.W       # :96

    @property
    def drho3(self):
        return (self.rhoh - self.rhol) / 3.0   # :101

    @property
    def wc(self):
        """Phase-field relaxation 1/(0.5 + 3M) (:247)."""
        return 1.0 / (0.5 + 3.0 * self.M)


class Fields(NamedTuple):
    C: torch.Tensor      # φ
    P: torch.Tensor      # p*
    rho: torch.Tensor
    mu: torch.Tensor     # μ_φ
    dC: torch.Tensor     # ∇φ (2, ny, nx)
    n: torch.Tensor      # ∇φ/|∇φ| (2, ny, nx)


def derive_fields(h, g, p: FakhariParams, lattice: Lattice = D2Q9) -> Fields:
    """φ, ρ, ∇φ, μ_φ, n, p* from the distributions (reference :297-347)."""
    C = h.sum(dim=0)
    rho = p.rhol + C * (p.rhoh - p.rhol)
    dC = isotropic_gradient(C, lattice)
    lap = lattice_laplacian(C, lattice)
    mu = 4.0 * p.beta * C * (C - 1.0) * (C - 0.5) - p.kappa * lap
    g2 = dC[0] ** 2 + dC[1] ** 2 + 1e-32
    n = dC * torch.rsqrt(g2)[None]
    P = g.sum(dim=0)
    return Fields(C=C, P=P, rho=rho, mu=mu, dC=dC, n=n)


def _stress_from_gneq(gneq, lattice: Lattice):
    """BGK stress moments Σ_{k≠rest} g^neq c c (reference :183-191)."""
    c = np.asarray(lattice.c)
    moving = (c != 0).any(axis=1)

    def moment(a, b):
        wts = torch.as_tensor(moving * c[:, a] * c[:, b], dtype=gneq.dtype,
                              device=gneq.device)
        return torch.einsum("k,k...->...", wts, gneq)

    return moment(0, 0), moment(0, 1), moment(1, 1)


def total_force(g, u, flds: Fields, p: FakhariParams, lattice: Lattice = D2Q9):
    """F = μ_φ∇φ + F_p + F_μ (reference :249-259 / :350-360).

    F_p = −p* (ρ_H−ρ_L)/3 ∇φ;  F_μ = (0.5−τ)/τ (S:∇φ)(ρ_H−ρ_L).
    """
    w, _ = lattice_tensors(lattice, g)
    geq = flds.P[None] * w.reshape((-1,) + (1,) * flds.P.ndim) + gamma_minus_w(u, lattice)
    sxx, sxy, syy = _stress_from_gneq(g - geq, lattice)
    fac = (0.5 - p.tau) / p.tau
    dR = p.rhoh - p.rhol
    FmX = fac * (sxx * flds.dC[0] + sxy * flds.dC[1]) * dR
    FmY = fac * (sxy * flds.dC[0] + syy * flds.dC[1]) * dR
    FpX = -flds.P * p.drho3 * flds.dC[0]
    FpY = -flds.P * p.drho3 * flds.dC[1]
    Fx = flds.mu * flds.dC[0] + FpX + FmX
    Fy = flds.mu * flds.dC[1] + FpY + FmY
    return torch.stack([Fx, Fy], dim=0)


def velocity_update(g, u_prev, flds: Fields, p: FakhariParams,
                    lattice: Lattice = D2Q9):
    """u = Σ ḡ c + F/(2ρ) (reference :362-368), F evaluated with u_prev."""
    F = total_force(g, u_prev, flds, p, lattice)
    _, c = lattice_tensors(lattice, g)
    mom = torch.einsum("kd,k...->d...", c, g)
    return mom + 0.5 * F / (flds.rho + EPS_C)[None]


def collide_stream(h, g, u, flds: Fields, p: FakhariParams,
                   lattice: Lattice = D2Q9):
    """Fused collision + periodic streaming of both distributions
    (reference collide_stream_at, :217-290)."""
    w, c = lattice_tensors(lattice, h)
    wk = w.reshape((lattice.q,) + (1,) * flds.C.ndim)

    GaWa = gamma_minus_w(u, lattice)                     # Γ−w (:174-180)
    Gamma = wk + GaWa

    # h equation (:238-247)
    shape = (1.0 - 4.0 * (flds.C - 0.5) ** 2) / p.W
    proj = torch.einsum("kd,d...->k...", c, flds.n)
    hlp_h = wk * shape[None] * proj
    heq = flds.C[None] * Gamma - 0.5 * hlp_h
    post_h = (1.0 - p.wc) * h + p.wc * heq + hlp_h

    # g equation (:249-274)
    F = total_force(g, u, flds, p, lattice)
    geq = flds.P[None] * wk + GaWa
    eF = torch.einsum("kd,d...->k...", c, F)
    hlp_g = 3.0 * wk * eF / (flds.rho + EPS_C)[None]
    geq_corr = geq - 0.5 * hlp_g
    post_g = (1.0 - p.s8) * g + p.s8 * geq_corr + hlp_g

    return stream_periodic(post_h, lattice), stream_periodic(post_g, lattice)


def step(state, p: FakhariParams, lattice: Lattice = D2Q9):
    """One full iteration: collide+stream, then macroscopic refresh
    (reference main loop :534-565)."""
    h, g, u = state
    flds = derive_fields(h, g, p, lattice)
    h2, g2 = collide_stream(h, g, u, flds, p, lattice)
    flds2 = derive_fields(h2, g2, p, lattice)
    u2 = velocity_update(g2, u, flds2, p, lattice)
    return (h2, g2, u2)


def run(state, p: FakhariParams, n_steps: int, lattice: Lattice = D2Q9):
    """Advance ``n_steps``; returns a new ``(h, g, u)``."""
    for _ in range(n_steps):
        state = step(state, p, lattice)
    return state


# ─── initial condition ─────────────────────────────────────────────────────
def init_bubble(nx, ny, p: FakhariParams, radius=None, dtype=torch.float32,
                *, device, lattice: Lattice = D2Q9):
    """tanh bubble (light phase inside) with Laplace-corrected p* init
    (reference iniCell, :141-168).  h and g are built in numpy float64
    exactly as the JAX version builds them, then cast; the one velocity
    update of the reference's initial ``update_fields`` (:522) runs in
    ``dtype``."""
    if radius is None:
        radius = nx / 8.0
    xc, yc = nx / 2.0 - 0.5, ny / 2.0 - 0.5
    X, Y = np.meshgrid(np.arange(nx), np.arange(ny))
    r = np.sqrt((X - xc) ** 2 + (Y - yc) ** 2)
    phi = 0.5 - 0.5 * np.tanh(2.0 * (radius - r) / p.W)
    rho = p.rhol + phi * (p.rhoh - p.rhol)
    P0 = -(phi * p.sigma / radius) / ((rho + 1e-12) / 3.0)
    w = np.asarray(lattice.w)
    npdtype = torch.empty((), dtype=dtype).numpy().dtype
    h = torch.from_numpy((phi[None] * w[:, None, None]).astype(npdtype)).to(device)
    g = torch.from_numpy((P0[None] * w[:, None, None]).astype(npdtype)).to(device)
    u0 = torch.zeros((2, ny, nx), dtype=dtype, device=device)
    flds = derive_fields(h, g, p, lattice)
    u0 = velocity_update(g, u0, flds, p, lattice)
    return (h, g, u0)


# ─── diagnostics ───────────────────────────────────────────────────────────
def total_mass(state, p: FakhariParams):
    C = state[0].sum(dim=0)
    return (p.rhol + C * (p.rhoh - p.rhol)).sum()


def kinetic_energy(state):
    u = state[2]
    return 0.5 * (u * u).sum() / (u.shape[-1] * u.shape[-2])


def phase_field(state):
    return state[0].sum(dim=0)


def pressure(state):
    return state[1].sum(dim=0)
