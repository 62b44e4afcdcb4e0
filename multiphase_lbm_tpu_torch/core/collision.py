"""Equilibria and collision operators (BGK, MRT).

Port of ``multiphase_lbm_tpu/core/collision.py``.  Contractions over the
velocity index run through ``torch.einsum`` / ``@`` with TF32 off (see
:mod:`.precision`), so float32 inputs keep every mantissa bit on a GPU.
MRT relaxation is one 9×9 matrix product over the flattened lattice
``(9, nelem)``.
"""
from __future__ import annotations

import numpy as np
import torch

from .lattice import K_FROM_I, Lattice


def lattice_tensors(lattice: Lattice, like):
    """``(w, c)`` of ``lattice`` as tensors of ``like``'s dtype on its
    device."""
    return (torch.as_tensor(lattice.w, dtype=like.dtype, device=like.device),
            torch.as_tensor(lattice.c, dtype=like.dtype, device=like.device))


# ─── equilibria ────────────────────────────────────────────────────────────
def equilibrium(rho, u, lattice: Lattice):
    """Standard second-order equilibrium
    ``f^eq_k = ρ w_k (1 + 3 c·u + 4.5 (c·u)² − 1.5 u²)``.

    Reference (D2Q9 BGK modules): ``laplace2D.h:272-283``.

    Args:
      rho: ``([z,] y, x)``.
      u: ``(d, [z,] y, x)`` ordered (ux, uy[, uz]).
    Returns: ``(Q, [z,] y, x)``.
    """
    w, c = lattice_tensors(lattice, rho)
    cu = torch.einsum("kd,d...->k...", c, u)
    usqr = 1.5 * torch.einsum("d...,d...->...", u, u)
    shape = (lattice.q,) + (1,) * rho.ndim
    return rho[None] * w.reshape(shape) * (1.0 + 3.0 * cu + 4.5 * cu * cu - usqr[None])


def gamma_minus_w(u, lattice: Lattice):
    """Fakhari Γ_k − w_k = w_k (3 c·u + 4.5 (c·u)² − 1.5 u²).

    Reference ``Young_Laplace2D.h:174-180``."""
    w, c = lattice_tensors(lattice, u)
    cu = torch.einsum("kd,d...->k...", c, u)
    usqr = 1.5 * torch.einsum("d...,d...->...", u, u)
    shape = (lattice.q,) + (1,) * (u.ndim - 1)
    return w.reshape(shape) * (3.0 * cu + 4.5 * cu * cu - usqr[None])


def pressure_equilibrium(P, u, rho0, lattice: Lattice):
    """Incompressible pressure-form equilibrium of the pulsatile module:
    ``g^eq_k = w_k (P + ρ₀/3 (c·u (3 + 4.5 c·u) − 1.5 u²))``.

    Reference ``PulsatileBloodFlow2D.h:501-507``.  Formed elementwise with
    one rounding per operation, in the order of the JAX version's
    arithmetic, so that it is the same on every device (a contraction on
    the card may fuse a multiply and an add); the pulsatile kernel rounds
    the same way."""
    w, c = lattice_tensors(lattice, P)
    shape = (lattice.q,) + (1,) * P.ndim
    ux, uy = u[0], u[1]
    usqr = 1.5 * (ux * ux + uy * uy)
    cu = c[:, 0].reshape(shape) * ux + c[:, 1].reshape(shape) * uy
    return w.reshape(shape) * (P + rho0 / 3.0 * (cu * (3.0 + 4.5 * cu) - usqr))


# ─── BGK ───────────────────────────────────────────────────────────────────
def bgk_collide(f, feq, omega):
    """``f' = (1 − ω) f + ω f^eq``."""
    return (1.0 - omega) * f + omega * feq


# ─── MRT (pulsatile-module variant) ────────────────────────────────────────
# The reference's CONVERT (PulsatileBloodFlow2D.h:509-519) is the classical
# Lallemand–Luo D2Q9 moment matrix written in "Abbas I" direction ordering
# (0=rest, 1=E, 2=N, 3=W, 4=S, 5=NE, 6=NW, 7=SW, 8=SE); RECONVERT (:520-531)
# is its exact inverse.  The reference feeds these matrices *k-ordered*
# population vectors (MRT_Collision at :533-541), a quirk reproduced
# verbatim: the matrices below are applied directly to k-ordered data.
MRT_M_I = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 1, 1],
        [-4, -1, -1, -1, -1, 2, 2, 2, 2],
        [4, -2, -2, -2, -2, 1, 1, 1, 1],
        [0, 1, 0, -1, 0, 1, -1, -1, 1],
        [0, -2, 0, 2, 0, 1, -1, -1, 1],
        [0, 0, 1, 0, -1, 1, 1, -1, -1],
        [0, 0, -2, 0, 2, 1, 1, -1, -1],
        [0, 1, -1, 1, -1, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 1, -1, 1, -1],
    ],
    dtype=np.float64,
)
MRT_M_I_INV = np.linalg.inv(MRT_M_I)

# Consistent-basis variant for the physics modes: the same Lallemand–Luo
# matrix with its columns permuted to the module k-ordering, so moments
# really are (ρ, e, ε, jx, qx, jy, qy, pxx, pxy) of the data fed in.
_I_FROM_K = np.argsort(np.asarray(K_FROM_I))
MRT_M_K = MRT_M_I[:, _I_FROM_K]
MRT_M_K_INV = np.linalg.inv(MRT_M_K)


def mrt_collide(f, feq, S, M=MRT_M_I, Minv=MRT_M_I_INV):
    """Moment-space relaxation: ``f' = f − M⁻¹ · diag(S) · M · (f − f^eq)``.

    Reference ``PulsatileBloodFlow2D.h:533-541``.  Shapes: ``f, feq``
    ``(Q, spatial...)``; ``S`` length-Q relaxation diagonal.  The 9×9
    operator is formed in float64 on the host, then cast to ``f.dtype``.
    """
    q = f.shape[0]
    A = (np.asarray(Minv) @ np.diag(np.asarray(S, dtype=np.float64)) @ np.asarray(M))
    A = torch.as_tensor(A, dtype=f.dtype, device=f.device)
    dneq = (f - feq).reshape(q, -1)
    dpost = (A @ dneq).reshape(f.shape)
    return f - dpost
