"""Shan–Chen Rayleigh–Taylor variant (ψ = 1 − e^(−ρ), Guo forcing), plain
PyTorch.

Port of ``multiphase_lbm_tpu/models/shan_chen_rt.py`` (reference
``shan-chen single component model/apps/RayleighTaylor2D.h``): exponential
pseudopotential, cos-perturbed tanh density interface, gravity, and
Guo-style forcing applied *inside* the collision (unlike the velocity-shift
scheme of :mod:`.shan_chen`); the fluid-wall force is present but zeroed
(reference :338-339), and wall-adjacent neighbour reads use the mirrored
cell (reference :260-276).  :func:`run` is a Python loop over :func:`step`,
the oracle that the CUDA kernel of :mod:`..ops.scrt_fused` is held against.

Functions that create tensors take an explicit ``device``; the rest run on
the device of their inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import eos
from ..core.collision import lattice_tensors
from ..core.lattice import D2Q9, Lattice
from ..core.streaming import stream_bounce_back
from ..utils.profiling import upload

RHO_FLOOR = 1e-14


@dataclasses.dataclass(frozen=True)
class SCRTParams:
    """The same fields and defaults as the JAX ``SCRTParams``
    (``config_RayleighTaylor2D.txt``)."""

    omega: float = 1.0
    rhol: float = 1.2
    rhog: float = 0.4
    g: float = -5.0          # fluid-fluid coupling strength
    gravity: float = -1.25e-5

    @property
    def tau(self):
        return 1.0 / self.omega


def density(f):
    return f.sum(dim=0)


def force_ff(rho, fluid, p: SCRTParams, lattice: Lattice = D2Q9):
    """F = −g ψ_c Σ w_k c_k ψ(ρ_nb) (+ mirrored reads at walls) + gravity·ρ ŷ
    (reference force_ff, :237-293): ψ(r − c_k) is read where r + c_k is
    solid."""
    psi = eos.psi_exponential(rho)
    dims = tuple(range(rho.ndim))
    shifts = lattice.roll_shifts()
    w, c = lattice.w, lattice.c
    fx = torch.zeros_like(rho)
    fy = torch.zeros_like(rho)
    for k in range(lattice.q):
        if not any(c[k]):
            continue
        neg = tuple(-s for s in shifts[k])
        nb_fluid = torch.roll(fluid, neg, dims=dims)
        fwd = torch.roll(psi, neg, dims=dims)
        bwd = torch.roll(psi, shifts[k], dims=dims)   # mirrored ψ at r − c_k
        psi_k = torch.where(nb_fluid, fwd, bwd)
        if c[k][0]:
            fx = fx + float(w[k] * c[k][0]) * psi_k
        if c[k][1]:
            fy = fy + float(w[k] * c[k][1]) * psi_k
    Fx = -p.g * psi * fx
    Fy = -p.g * psi * fy + p.gravity * rho
    return torch.stack([Fx, Fy], dim=0)


def step(f, fluid, p: SCRTParams, lattice: Lattice = D2Q9):
    """BGK with Guo forcing at u_eq = u + F/(2ρ) (reference u_eq :392-401,
    collideBgk :369-405), then bounce-back pull streaming."""
    return step_with_gravity(f, fluid, p, p.gravity, lattice)


def step_with_gravity(f, fluid, p: SCRTParams, gravity, lattice: Lattice = D2Q9):
    """Same step with gravity as an argument (a float or a tensor, so that a
    calibration can take its gradient through force, collision and
    streaming)."""
    w, c = lattice_tensors(lattice, f)
    rho = density(f)
    rho_safe = torch.clamp_min(rho, RHO_FLOOR)
    mom = torch.einsum("kd,k...->d...", c, f)
    u = mom / rho_safe[None]
    F = force_ff(rho, fluid, p, lattice)
    # swap the parameter's gravity contribution for the argument's
    F = torch.stack([F[0], F[1] + (gravity - p.gravity) * rho], dim=0)
    ueq = u + 0.5 * F / rho_safe[None]

    cu = torch.einsum("kd,d...->k...", c, ueq)
    usqr = 1.5 * torch.einsum("d...,d...->...", ueq, ueq)
    wk = w.reshape((lattice.q,) + (1,) * rho.ndim)
    feq = rho[None] * wk * (1.0 + 3.0 * cu + 4.5 * cu * cu - usqr[None])

    # Guo source: w_k (1−ω/2) [3(c−u) + 9(c·u)c]·F  (reference :398-399)
    cF = torch.einsum("kd,d...->k...", c, F)
    e_uF = cF - torch.einsum("d...,d...->...", ueq, F)[None]
    src = wk * (1.0 - 0.5 * p.omega) * (3.0 * e_uF + 9.0 * cu * cF)

    post = (1.0 - p.omega) * f + p.omega * feq + src
    post = post * fluid[None].to(f.dtype)
    return stream_bounce_back(post, fluid, lattice)


def run(f, fluid, p: SCRTParams, n_steps: int, lattice: Lattice = D2Q9):
    """Advance ``n_steps``; returns a new ``f``."""
    for _ in range(n_steps):
        f = step(f, fluid, p, lattice)
    return f


# ─── initial condition / geometry ──────────────────────────────────────────
def init_interface(nx, ny, p: SCRTParams, dtype=torch.float64, *, device,
                   lattice: Lattice = D2Q9):
    """Cos-perturbed tanh density interface, heavy on top
    (reference iniLattice, :134-158; width 2.5).  Built in numpy float64
    exactly as the JAX version builds it (``nx − 1`` in the cosine
    included), then cast."""
    X, Y = np.meshgrid(np.arange(nx, dtype=float), np.arange(ny, dtype=float))
    interface = ny / 2.0 + nx * 0.1 * np.cos(2.0 * np.pi * X / (nx - 1))
    rho = (0.5 * (p.rhol + p.rhog)
           + 0.5 * (p.rhol - p.rhog) * np.tanh((Y - interface) / 5.0))
    w = np.asarray(lattice.w)
    npdtype = torch.empty((), dtype=dtype).numpy().dtype
    return upload((rho[None] * w[:, None, None]).astype(npdtype), device)


def geometry_channel(nx, ny, *, device):
    """Walls at y = 0 and y = ny − 1, periodic in x."""
    fluid = torch.ones((ny, nx), dtype=torch.bool, device=device)
    fluid[0] = False
    fluid[-1] = False
    return fluid


# ─── diagnostics ───────────────────────────────────────────────────────────
def kinetic_energy(f, fluid, p: SCRTParams, lattice: Lattice = D2Q9):
    """Mean kinetic energy ½⟨|u + F/2ρ|²⟩ over the box (the reference
    RayleighTaylor2D.h main loop's computeEnergy → energy.dat log)."""
    _, c = lattice_tensors(lattice, f)
    rho = density(f)
    rho_safe = torch.clamp_min(rho, RHO_FLOOR)
    u = torch.einsum("kd,k...->d...", c, f) / rho_safe[None]
    F = force_ff(rho, fluid, p, lattice)
    ua = u + 0.5 * F / rho_safe[None]
    e = (torch.where(fluid[None], ua, 0.0) ** 2).sum()
    return 0.5 * e / fluid.numel()


def interface_height(rho_host: np.ndarray, fluid_host: np.ndarray,
                     p: SCRTParams):
    """Spike and bubble rows of the record, in lattice units: the topmost
    fluid row whose ρ is at most the mean of ρ_l and ρ_g, in the column
    x = nx/2 (the spike) and x = 0 (the bubble), 0 where the column has
    none; host numpy in, floats out.  This is the PF module's
    findInterfaceHeights applied to ρ, as the C++ capture's spike and bubble
    rows at steps 1000, 2000 and 3000 show (:mod:`..validation.scrt_reference`).
    The JAX package's rule (the lowest heavy row of x = 0 and the highest
    light row of x = nx/2) differs from them."""
    rho_cut = 0.5 * (p.rhol + p.rhog)

    def top_light_row(x):
        rows = np.nonzero((rho_host[:, x] <= rho_cut) & fluid_host[:, x])[0]
        return float(rows[-1]) if rows.size else 0.0

    return top_light_row(rho_host.shape[1] // 2), top_light_row(0)
