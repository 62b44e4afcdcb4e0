"""Plain reference of the Shan–Chen Rayleigh–Taylor channel (D2Q9).

Written from the reference solver's equations (``shan-chen single component
model/apps/RayleighTaylor2D.h``): the density ρ = Σf and ρ_safe = max(ρ,
1e-14), the velocity u = Σ c f / ρ_safe, the exponential pseudopotential
ψ = 1 − e^(−ρ) (:194-196), the fluid–fluid force F = −g ψ Σ_k w_k c_k ψ_k
with ψ_k read at r − c_k where r + c_k is a wall cell (:260-276), plus
gravity·ρ on y, the equilibrium at u_eq = u + F/(2ρ_safe), the Guo source
w_k (1 − ω/2) [3 (c_k − u_eq)·F + 9 (c_k·u_eq)(c_k·F)] inside BGK
(:372-405), zero on the wall rows y = 0 and y = ny − 1, and pull streaming
with on-site bounce-back off them, on the channel N × (4N + 2) (:622).
The initial state is the cos-perturbed tanh interface at rest (:134-158).
The driver's records (:578-670): the energy ½ Σ_fluid |u + F/(2ρ_safe)|² /
(nx·ny), scaled by (dx/dt)², the mass Σ ρ over the fluid, and the spike and
bubble rows (the topmost light rows of x = nx/2 and x = 0).  Its VTK dump
holds the density and the solid flag.  Plain PyTorch on whole tensors, in
the dtype of the state it is given; it imports nothing of the program under
test.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# float32 products must not run in TF32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# D2Q9 in the reference module's order, rest at k = 4
C = ((-1, 0), (0, -1), (-1, -1), (-1, 1), (0, 0), (1, 0), (0, 1), (1, 1), (1, -1))
W = (1 / 9, 1 / 9, 1 / 36, 1 / 36, 4 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36)
OPP = (5, 6, 7, 8, 4, 0, 1, 2, 3)
RHO_FLOOR = 1e-14


def params(cfg: dict) -> dict:
    """The driver's parameters from the case file's keys, with the driver's
    defaults where a key is absent (ν = u_lb·N/Re, the channel N × (4N + 2))."""
    def num(key, default):
        return float(cfg.get(key, default))

    N = int(num("N", 128))
    ulb = num("ulb", 0.04)
    dx = 1.0 / N
    return {"nx": N, "ny": 4 * N + 2, "cells": N * (4 * N + 2),
            "omega": 1.0 / (3.0 * ulb * N / num("Re", 30.72) + 0.5),
            "rhol": num("rhol", 1.2), "rhog": num("rhog", 0.4),
            "g": num("g", -5.0), "gravity": num("gravity", -1.25e-5),
            "dx": dx, "dt": dx * ulb,
            "out_freq": int(num("out_freq", 100)),
            "vtk_freq": int(num("vtk_freq", 100))}


def _fluid(prm, device):
    fluid = torch.ones((prm["ny"], prm["nx"]), dtype=torch.bool, device=device)
    fluid[0] = False
    fluid[-1] = False
    return fluid


def _shift(q, cx, cy):
    """q at r + c (rolled; the walls are handled by the caller)."""
    return torch.roll(q, (-cy, -cx), dims=(0, 1))


def initial(prm, dtype=torch.float64, device="cpu"):
    """The populations at rest on the interface y = ny/2 + 0.1·nx·cos(2π
    x/(nx − 1)), ρ = (ρ_l + ρ_g)/2 + (ρ_l − ρ_g)/2 · tanh((y − interface)/5),
    heavy on top; zero on the wall rows."""
    nx, ny = prm["nx"], prm["ny"]
    x = torch.arange(nx, dtype=torch.float64, device=device)
    y = torch.arange(ny, dtype=torch.float64, device=device)[:, None]
    interface = ny / 2.0 + nx * 0.1 * torch.cos(2.0 * math.pi * x / (nx - 1))
    rho = (0.5 * (prm["rhol"] + prm["rhog"])
           + 0.5 * (prm["rhol"] - prm["rhog"]) * torch.tanh((y - interface) / 5.0))
    rho = rho * _fluid(prm, device)
    return (torch.stack([w * rho for w in W]).to(dtype),)


def _fields(f, fluid, prm):
    """ρ, ρ_safe, u and F of the populations ``f``."""
    rho = f.sum(0)
    rho_safe = torch.clamp(rho, min=RHO_FLOOR)
    ux = sum(cx * f[k] for k, (cx, cy) in enumerate(C) if cx) / rho_safe
    uy = sum(cy * f[k] for k, (cx, cy) in enumerate(C) if cy) / rho_safe
    psi = 1.0 - torch.exp(-rho)
    sx = torch.zeros_like(rho)
    sy = torch.zeros_like(rho)
    for k, (cx, cy) in enumerate(C):
        if not (cx or cy):
            continue
        psi_k = torch.where(_shift(fluid, cx, cy), _shift(psi, cx, cy),
                            _shift(psi, -cx, -cy))
        if cx:
            sx = sx + W[k] * cx * psi_k
        if cy:
            sy = sy + W[k] * cy * psi_k
    Fx = -prm["g"] * psi * sx
    Fy = -prm["g"] * psi * sy + prm["gravity"] * rho
    return rho, rho_safe, ux, uy, Fx, Fy


def _step(f, fluid, mask, prm):
    rho, rho_safe, ux, uy, Fx, Fy = _fields(f, fluid, prm)
    uex = ux + 0.5 * Fx / rho_safe
    uey = uy + 0.5 * Fy / rho_safe
    usq = 1.5 * (uex * uex + uey * uey)
    uF = uex * Fx + uey * Fy
    om = prm["omega"]
    post = []
    for k, (cx, cy) in enumerate(C):
        cu = cx * uex + cy * uey
        feq = rho * W[k] * (1.0 + 3.0 * cu + 4.5 * cu * cu - usq)
        cF = cx * Fx + cy * Fy
        src = W[k] * (1.0 - 0.5 * om) * (3.0 * (cF - uF) + 9.0 * cu * cF)
        post.append(((1.0 - om) * f[k] + om * feq + src) * mask)
    out = []
    for k, (cx, cy) in enumerate(C):
        up_fluid = _shift(fluid, -cx, -cy)
        out.append(torch.where(up_fluid, _shift(post[k], -cx, -cy), post[OPP[k]]) * mask)
    return torch.stack(out)


def step(state, prm, n):
    """``n`` steps of ``state = (f,)``."""
    f, = state
    fluid = _fluid(prm, f.device)
    mask = fluid.to(f.dtype)
    for _ in range(n):
        f = _step(f, fluid, mask, prm)
    return (f,)


def _rows(rho, fluid, prm):
    """The spike and the bubble: the topmost fluid row whose ρ is at most
    the mean of ρ_l and ρ_g, in the column x = nx/2 and in x = 0, 0 where
    the column has none (the C++ capture's rows at steps 1000, 2000 and
    3000 follow this rule)."""
    cut = 0.5 * (prm["rhol"] + prm["rhog"])

    def top_light_row(x):
        rows = torch.nonzero((rho[:, x] <= cut) & fluid[:, x])
        return int(rows.max()) if len(rows) else 0

    return top_light_row(prm["nx"] // 2), top_light_row(0)


def records(states, prm):
    """The lines the driver writes at each record whose state is given
    (``{it: (f,)}``): ``{file: {line: [columns]}}``."""
    out = {"energy.dat": {}, "mass.dat": {}, "spike_bubble_position.dat": {}}
    dx, dt = prm["dx"], prm["dt"]
    for it, (f,) in states.items():
        if it % prm["out_freq"]:
            continue
        fluid = _fluid(prm, f.device)
        rho, rho_safe, ux, uy, Fx, Fy = _fields(f, fluid, prm)
        zero = torch.zeros_like(ux)
        ax = torch.where(fluid, ux + 0.5 * Fx / rho_safe, zero)
        ay = torch.where(fluid, uy + 0.5 * Fy / rho_safe, zero)
        e = 0.5 * float((ax * ax + ay * ay).sum()) / fluid.numel()
        spike, bubble = _rows(rho, fluid, prm)
        line, t = it // prm["out_freq"], it * dt
        out["energy.dat"][line] = [t, e * dx * dx / (dt * dt)]
        out["mass.dat"][line] = [t, float(torch.where(fluid, rho, zero).sum())]
        out["spike_bubble_position.dat"][line] = [t, spike * dx, bubble * dx]
    return out


def record_counts(prm, steps):
    """Lines of each ``.dat`` file after a run of ``steps`` steps."""
    n = -(-steps // prm["out_freq"]) if prm["out_freq"] else 0
    return {"energy.dat": n, "mass.dat": n, "spike_bubble_position.dat": n}


def dump_count(prm, steps):
    return -(-steps // prm["vtk_freq"]) if prm["vtk_freq"] else 0


# a value under this share of its field's largest is round-off of a
# cancellation, and its digits are not compared
FLOOR = 1e-6


def _fmt(a):
    """C++ ``operator<<(float)`` of each value (6 significant digits), and
    which values carry digits above round-off of the field's largest."""
    v = a.detach().cpu().numpy().ravel()
    counted = np.abs(v) >= FLOOR * np.abs(v).max()
    return np.char.mod("%g", v.astype(np.float32)).tolist(), counted.tolist()


def vtk_tokens(state, prm, it):
    """The whitespace-separated tokens of the legacy-VTK dump at ``it``: the
    density as float32 ``%g``, then the solid flag (1 on the walls) as
    integers, x fastest, on spacing 1/N; and for each token whether it is
    compared (every token but the digits of round-off values)."""
    f, = state
    nx, ny, s = prm["nx"], prm["ny"], f"{prm['dx']:g}"
    tok = ["#", "vtk", "DataFile", "Version", "2.0", "iteration", str(it),
           "ASCII", "DATASET", "STRUCTURED_POINTS", "DIMENSIONS", str(nx),
           str(ny), "1", "ORIGIN", "0", "0", "0", "SPACING", s, s, s,
           "POINT_DATA", str(nx * ny)]
    counted = [True] * len(tok)
    head = ["SCALARS", "Density", "float", "1", "LOOKUP_TABLE", "default"]
    vals, keep = _fmt(f.sum(0))
    tok += head + vals
    counted += [True] * len(head) + keep
    flag = (~_fluid(prm, f.device)).to(torch.int64).cpu().numpy().ravel()
    head = ["SCALARS", "Flag", "int", "1", "LOOKUP_TABLE", "default"]
    tok += head + [str(v) for v in flag.tolist()]
    counted += [True] * (len(head) + flag.size)
    return tok, counted


def dump_name(it):
    return f"sol_{it:07d}.vtk"
