"""Carry parameters and state from the JAX package to the port.

Both sides exchange plain Python and numpy values, so nothing here imports
jax: a caller holding a JAX ``SCParams``, ``HCZParams``, ``FakhariParams``,
``SCRTParams``, ``PulsatileParams`` or ``CombustionParams`` passes
``dataclasses.asdict`` of it, and JAX arrays as ``np.asarray`` copies.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.combustion import CombustionParams, CombustionState
from ..models.fakhari import FakhariParams
from ..models.hcz import HCZParams
from ..models.pulsatile import PulsatileParams, PulsatileState
from ..models.shan_chen import SCParams
from ..models.shan_chen_rt import SCRTParams


def params_from_jax(d: dict) -> SCParams:
    """The port's ``SCParams`` from ``dataclasses.asdict`` of the JAX one
    (the two dataclasses have the same fields; an unknown key raises)."""
    return SCParams(**d)


def hcz_params_from_jax(d: dict) -> HCZParams:
    """The port's ``HCZParams`` from ``dataclasses.asdict`` of the JAX one
    (same fields; an unknown key raises)."""
    return HCZParams(**d)


def fakhari_params_from_jax(d: dict) -> FakhariParams:
    """The port's ``FakhariParams`` from ``dataclasses.asdict`` of the JAX
    one (same fields; an unknown key raises)."""
    return FakhariParams(**d)


def scrt_params_from_jax(d: dict) -> SCRTParams:
    """The port's ``SCRTParams`` from ``dataclasses.asdict`` of the JAX one
    (same fields; an unknown key raises)."""
    return SCRTParams(**d)


def pulsatile_params_from_jax(d: dict) -> PulsatileParams:
    """The port's ``PulsatileParams`` from ``dataclasses.asdict`` of the
    JAX one (same fields; an unknown key raises)."""
    return PulsatileParams(**d)


def state_from_numpy(f_np, fluid_np, device, dtype=torch.float64):
    """``(f, fluid)`` tensors on ``device``: populations ``(9, ny, nx)`` in
    ``dtype`` and the bool fluid mask ``(ny, nx)``."""
    f = torch.as_tensor(np.array(f_np), dtype=dtype, device=device)
    fluid = torch.as_tensor(np.array(fluid_np, dtype=bool), device=device)
    return f, fluid


def hcz_state_from_numpy(f_np, g_np, fluid_np, device, dtype=torch.float64):
    """``((f, g), fluid)`` on ``device``: the two distributions
    ``(Q, *lattice)`` in ``dtype`` and the bool fluid mask ``lattice``."""
    f, fluid = state_from_numpy(f_np, fluid_np, device, dtype)
    g = torch.as_tensor(np.array(g_np), dtype=dtype, device=device)
    return (f, g), fluid


def fakhari_state_from_numpy(h_np, g_np, u_np, device, dtype=torch.float64):
    """The Fakhari state ``(h, g, u)`` on ``device`` in ``dtype``: the two
    distributions ``(9, ny, nx)`` and the velocity ``(2, ny, nx)``."""
    return tuple(torch.as_tensor(np.array(a), dtype=dtype, device=device)
                 for a in (h_np, g_np, u_np))


def pulsatile_state_from_numpy(g_coll, g_stream, yr1, yr2, P, Ux, Uy, F,
                               fluid, device, dtype=torch.float64):
    """A :class:`PulsatileState` on ``device`` from the nine fields of the
    JAX one (numpy arrays, in its field order): ``fluid`` as bool, the rest
    in ``dtype``."""
    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return PulsatileState(
        t(g_coll), t(g_stream), t(yr1), t(yr2), t(P), t(Ux), t(Uy), t(F),
        torch.as_tensor(np.array(fluid, dtype=bool), device=device))


def combustion_params_from_jax(d: dict) -> CombustionParams:
    """The port's ``CombustionParams`` from ``dataclasses.asdict`` of the
    JAX one (same fields; an unknown key raises)."""
    return CombustionParams(**d)


def combustion_state_from_numpy(f, gO2, gCO2, gT, F_O2_prev, F_CO2_prev,
                                F_T_prev, g_coll, q_heat, device,
                                dtype=torch.float64):
    """A :class:`CombustionState` on ``device`` in ``dtype`` from the nine
    fields of the JAX one (numpy arrays, in its field order)."""
    return CombustionState(*(
        torch.as_tensor(np.array(a), dtype=dtype, device=device)
        for a in (f, gO2, gCO2, gT, F_O2_prev, F_CO2_prev, F_T_prev, g_coll,
                  q_heat)))
