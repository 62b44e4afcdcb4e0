"""Weighted lattice stencil operators (isotropic ∇, ∇², ∇∇²).

Port of ``multiphase_lbm_tpu/core/stencil.py``.  Near walls the reference
replaces a solid neighbour's value by the value at the *mirrored* node
``r - c_k`` (bounce-back-aware stencils, reference
``Phase field model/apps/rayleighTaylor2D.h:248-310, 467-529``); here each
stencil is a set of whole-tensor rolls and selects, the same rule as the
JAX version, and the gradient of the Laplacian is taken of a materialised
Laplacian field.

Conventions (c_s² = 1/3):
  grad  q = 3 Σ_k w_k c_k q(r + c_k)                  (1/c_s² scaling)
  lap   q = 6 Σ_k w_k (q(r + c_k) − q(r))             (2/c_s² scaling)
"""
from __future__ import annotations

from typing import Optional

import torch

from .lattice import Lattice


def neighbor_values(q, lattice: Lattice, fluid: Optional[torch.Tensor] = None):
    """Stacked neighbour values ``v[k] = q(r + c_k)``, shape
    ``(Q, [z,] y, x)``; with a bool ``fluid`` mask, ``q(r - c_k)`` is read
    where ``r + c_k`` is solid (reference rayleighTaylor2D.h:261-269)."""
    dims = tuple(range(q.ndim))
    shifts = lattice.roll_shifts()
    vals = []
    for k in range(lattice.q):
        neg = tuple(-s for s in shifts[k])
        fwd = torch.roll(q, neg, dims=dims)            # q at r + c_k
        if fluid is None:
            vals.append(fwd)
        else:
            bwd = torch.roll(q, shifts[k], dims=dims)  # mirrored: q at r - c_k
            nb_fluid = torch.roll(fluid, neg, dims=dims)
            vals.append(torch.where(nb_fluid, fwd, bwd))
    return torch.stack(vals, dim=0)


def isotropic_gradient(q, lattice: Lattice, fluid: Optional[torch.Tensor] = None):
    """``∇q = 3 Σ_k w_k c_k q(r+c_k)``, shape ``(d, [z,] y, x)`` ordered
    (∂x, ∂y[, ∂z])."""
    vals = neighbor_values(q, lattice, fluid)
    wc = torch.as_tensor(lattice.w[:, None] * lattice.c, dtype=q.dtype,
                         device=q.device)
    return 3.0 * torch.einsum("kd,k...->d...", wc, vals)


def lattice_laplacian(q, lattice: Lattice, fluid: Optional[torch.Tensor] = None):
    """``∇²q = 6 Σ_k w_k (q(r+c_k) − q(r))``."""
    vals = neighbor_values(q, lattice, fluid)
    w = torch.as_tensor(lattice.w, dtype=q.dtype, device=q.device)
    return 6.0 * torch.einsum("k,k...->...", w, vals - q[None])


def grad_of_laplacian(q, lattice: Lattice, fluid: Optional[torch.Tensor] = None):
    """``∇(∇²q)``: the Laplacian materialised once, then its gradient, both
    with the mirrored reads (what the reference's recursive per-neighbour
    evaluation computes)."""
    lap = lattice_laplacian(q, lattice, fluid)
    return isotropic_gradient(lap, lattice, fluid)
