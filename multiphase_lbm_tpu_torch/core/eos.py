"""Equation-of-state / pseudopotential library.

Port of ``multiphase_lbm_tpu/core/eos.py``: the same closed forms (citations
inline), elementwise on tensors.  The pure-arithmetic forms also accept
numpy arrays and Python floats (``models.shan_chen.compute_p_shift`` feeds
``yuan_pressure`` a numpy grid); the branch selects need a tensor.
"""
from __future__ import annotations

import torch

CS2 = 1.0 / 3.0


def _branch(cond, pos, neg, like):
    """``where(cond, pos, neg)`` in ``like``'s dtype and device (a select of
    two Python scalars would take torch's default dtype)."""
    return torch.where(cond, like.new_full((), pos), like.new_full((), neg))


# ─── Carnahan–Starling bulk pressure (phase-field family) ──────────────────
def carnahan_starling_pressure(rho, a, b):
    """p(ρ) = (ρ/3)(1 + rt + rt² − rt³)/(1 − rt)³ − aρ², rt = bρ/4.

    Reference: ``Phase field model/apps/rayleighTaylor2D.h:179-184``.
    """
    rt = b * rho / 4.0
    return (rho / 3.0) * (1.0 + rt + rt * rt - rt**3) / (1.0 - rt) ** 3 - a * rho * rho


def cs_psi(rho, a, b):
    """ψ(ρ) = p_CS(ρ) − ρ/3 (non-ideal part), used by the HCZ forcing terms.

    Reference: ``rayleighTaylor2D.h:374-379`` (psi_rho), ``:237-242`` (psi_phi).
    """
    return carnahan_starling_pressure(rho, a, b) - rho / 3.0


# ─── Yuan–CS (Shan–Chen single component) ──────────────────────────────────
def yuan_Z(rho):
    """Compressibility factor Z(ρ) = 1 + (4ρ − 2ρ²)/(1 − ρ)³.

    Reference: ``shan-chen…/apps/laplace2D.h:175-179``.
    """
    d = 1.0 - rho
    return 1.0 + (4.0 * rho - 2.0 * rho * rho) / (d * d * d)


def yuan_pressure(rho, a, R, T):
    """P(ρ) = ρ R T Z(ρ) − aρ².  Reference ``laplace2D.h:181-183``."""
    return rho * R * T * yuan_Z(rho) - a * rho * rho


def yuan_Tc(a, b, R):
    """Critical temperature Tc = 0.3773 a/(bR).  Reference ``laplace2D.h:469-470``."""
    return 0.3773 * a / (b * R)


def yuan_G1(rho, a, R, T):
    """Sign-branched interaction strength G₁ = ±c_s².

    Reference ``laplace2D.h:185-188``: positive branch when
    R·T·Z(ρ) − aρ − c_s² > 0.
    """
    s = R * T * yuan_Z(rho) - a * rho - CS2
    return _branch(s > 0.0, CS2, -CS2, s)


def yuan_psi(rho, a, R, T, p_shift=0.0):
    """ψ(ρ) = sqrt(max(0, 6 (P(ρ) + p_shift − c_s² ρ)/G₁)).

    Reference ``laplace2D.h:190-195``; the ``p_shift`` regularisation comes
    from the layered-flow module (``shan-chen…/apps/twoLayeredFlow2D.h:181-188``)
    which adds a constant pressure shift so ψ² ≥ 0 across [ρ_g, ρ_l].
    """
    P = yuan_pressure(rho, a, R, T) + p_shift
    G1 = yuan_G1(rho, a, R, T)
    val = 6.0 * (P - CS2 * rho) / G1
    return torch.sqrt(torch.clamp_min(val, 0.0))


def yuan_psi_fixed_branch(rho, a, R, T, G1, p_shift=0.0):
    """ψ of a *virtual* density evaluated on a caller-supplied G₁ branch.

    Used for the wall pseudo-potential which shares the branch of the current
    fluid node (reference ``contactAngle2D.h:259-262``)."""
    val = 6.0 * rho * (R * T * yuan_Z(rho) - a * rho - CS2) / G1
    # identical to 6 (P + shift − cs2 ρ)/G1 when shift = 0; keep the shift too
    val = val + 6.0 * p_shift / G1
    return torch.sqrt(torch.clamp_min(val, 0.0))


def yuan_node_pressure(rho, a, R, T, p_shift=0.0):
    """Lattice pressure p = c_s²ρ + G₁/6 ψ², reference ``laplace2D.h:308-315``."""
    psi = yuan_psi(rho, a, R, T, p_shift)
    G1 = yuan_G1(rho, a, R, T)
    return CS2 * rho + G1 / 6.0 * psi * psi


# ─── Exponential pseudopotential (SC Rayleigh–Taylor) ──────────────────────
def psi_exponential(rho):
    """ψ(ρ) = 1 − e^(−ρ).  Reference ``shan-chen…/apps/RayleighTaylor2D.h:194-196``."""
    return 1.0 - torch.exp(-rho)


# ─── Double-well chemical potential (Fakhari conservative PF) ──────────────
def double_well_mu(phi, beta, kappa, lap_phi):
    """μ_φ = 4β φ(φ−1)(φ−0.5) − κ∇²φ.  Reference ``Young_Laplace2D.h:323-331``."""
    return 4.0 * beta * phi * (phi - 1.0) * (phi - 0.5) - kappa * lap_phi
