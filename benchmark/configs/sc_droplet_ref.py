"""Plain reference of the Shan–Chen Yuan–CS droplet: periodic D2Q9, BGK.

Written from the reference solver's equations (``shan-chen single component
model/apps/laplace2D.h``): Yuan–Carnahan–Starling pressure and its ψ with
the sign-branched G₁ (:175-195), the fluid–fluid force (:198-242), the
velocity shift u + τF/ρ in the equilibrium (:245-251), BGK, pull streaming,
and the diagnostics of the driver (energy :368-380, mass :382-393, node
pressure :308-315, the VTK fields :319-365).  Plain PyTorch on whole
tensors, in the dtype of the state it is given; it imports nothing of the
program under test.
"""
from __future__ import annotations

import numpy as np
import torch

# D2Q9 in the reference module's order, rest at k = 4 (laplace2D.h:29-41)
C = ((-1, 0), (0, -1), (-1, -1), (-1, 1), (0, 0), (1, 0), (0, 1), (1, 1), (1, -1))
W = (1 / 9, 1 / 9, 1 / 36, 1 / 36, 4 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36)
CS2 = 1.0 / 3.0
RHO_FLOOR = 1e-14


def params(cfg: dict) -> dict:
    """The driver's parameters from the case file's keys, with the driver's
    defaults where a key is absent (τ from ``tau`` when positive, else from
    Re and u_lb at L = N)."""
    def num(key, default):
        return float(cfg.get(key, default))

    N = int(num("N", 100))
    ulb = num("ulb", 0.1)
    tau = num("tau", -1.0)
    if tau > 0:
        omega = 1.0 / tau
    else:
        omega = 1.0 / (3.0 * ulb * N / num("Re", 60.0) + 0.5)
    a, b, R = num("a", 1.0), num("b", 4.0), num("R", 1.0)
    dx = 1.0 / N
    return {"nx": N, "ny": N, "cells": N * N, "omega": omega, "a": a, "R": R,
            "T": num("TT0", 0.875) * 0.3773 * a / (b * R),
            "dx": dx, "dt": dx * ulb,
            "out_freq": int(num("out_freq", 400)),
            "vtk_freq": int(num("vtk_freq", 400))}


def _psi_g1(rho, prm):
    Z = 1.0 + (4.0 * rho - 2.0 * rho * rho) / (1.0 - rho) ** 3
    RTZ = prm["R"] * prm["T"] * Z
    G1 = torch.where(RTZ - prm["a"] * rho - CS2 > 0.0, rho.new_full((), CS2),
                     rho.new_full((), -CS2))
    P = rho * RTZ - prm["a"] * rho * rho
    return torch.sqrt(torch.clamp_min(6.0 * (P - CS2 * rho) / G1, 0.0)), G1


def _at(q, cx, cy):
    """q at r + c (periodic)."""
    return torch.roll(q, (-cy, -cx), dims=(0, 1))


def _macro(f, prm):
    """ρ, the bare velocity and the Shan–Chen force of populations f."""
    rho = f.sum(0)
    rho_s = torch.clamp_min(rho, RHO_FLOOR)
    psi, G1 = _psi_g1(rho, prm)
    sx = torch.zeros_like(rho)
    sy = torch.zeros_like(rho)
    ux = torch.zeros_like(rho)
    uy = torch.zeros_like(rho)
    for k, (cx, cy) in enumerate(C):
        ux = ux + cx * f[k]
        uy = uy + cy * f[k]
        if cx or cy:
            nb = W[k] * _at(psi, cx, cy)
            sx = sx + cx * nb
            sy = sy + cy * nb
    F = (-G1 * psi * sx, -G1 * psi * sy)
    return rho, rho_s, (ux / rho_s, uy / rho_s), F, psi, G1


def _step(f, prm):
    rho, rho_s, (ux, uy), (Fx, Fy), _, _ = _macro(f, prm)
    tau, om = 1.0 / prm["omega"], prm["omega"]
    vx = ux + tau * Fx / rho_s
    vy = uy + tau * Fy / rho_s
    usq = 1.5 * (vx * vx + vy * vy)
    out = []
    for k, (cx, cy) in enumerate(C):
        cu = cx * vx + cy * vy
        feq = rho * W[k] * (1.0 + 3.0 * cu + 4.5 * cu * cu - usq)
        post = (1.0 - om) * f[k] + om * feq
        out.append(torch.roll(post, (cy, cx), dims=(0, 1)))
    return torch.stack(out)


def step(state, prm, n):
    """``n`` steps of the populations ``state = (f,)``."""
    (f,) = state
    for _ in range(n):
        f = _step(f, prm)
    return (f,)


def _energy_mass(f, prm):
    rho, rho_s, (ux, uy), (Fx, Fy), _, _ = _macro(f, prm)
    ax = ux + 0.5 * Fx / rho_s
    ay = uy + 0.5 * Fy / rho_s
    e = 0.5 * (ax * ax + ay * ay).sum() / rho.numel()
    return (float(e) * prm["dx"] ** 2 / prm["dt"] ** 2, float(rho.sum()))


def records(states, prm):
    """The ``.dat`` lines the driver writes at each record whose state is
    given (``{it: (f,)}``): ``{file: {line: [columns]}}``."""
    out = {"energy.dat": {}, "mass.dat": {}}
    for it, (f,) in states.items():
        if it % prm["out_freq"]:
            continue
        e, m = _energy_mass(f, prm)
        line = it // prm["out_freq"]
        out["energy.dat"][line] = [it * prm["dt"], e]
        out["mass.dat"][line] = [it * prm["dt"], m]
    return out


def record_counts(prm, steps):
    """Lines of each ``.dat`` file after a run of ``steps`` steps."""
    n = -(-steps // prm["out_freq"]) if prm["out_freq"] else 0
    return {"energy.dat": n, "mass.dat": n}


# a value under this share of its field's largest is round-off of a
# cancellation (the force in the bulk), and its digits are not compared
FLOOR = 1e-6


def _fmt(a, scale):
    """C++ ``operator<<(float)``: 6 significant digits; and which values
    carry digits above round-off of a field whose largest value is
    ``scale``."""
    v = a.detach().cpu().numpy().ravel()
    counted = np.abs(v) >= FLOOR * scale
    return np.char.mod("%g", v.astype(np.float32)).tolist(), counted.tolist()


def vtk_tokens(state, prm, it):
    """The whitespace-separated tokens of the legacy-VTK dump at ``it``
    (laplace2D.h:319-365): Density, Pressure and the Force vector with a
    zero z component, x fastest; and for each token whether it is compared
    (every token but the digits of round-off values)."""
    (f,) = state
    rho, _, _, (Fx, Fy), psi, G1 = _macro(f, prm)
    nx, ny, s = prm["nx"], prm["ny"], f"{prm['dx']:g}"
    tok = ["#", "vtk", "DataFile", "Version", "2.0", "iteration", str(it),
           "ASCII", "DATASET", "STRUCTURED_POINTS", "DIMENSIONS", str(nx),
           str(ny), "1", "ORIGIN", "0", "0", "0", "SPACING", s, s, s,
           "POINT_DATA", str(nx * ny)]
    counted = [True] * len(tok)
    for name, field in (("Density", rho), ("Pressure", CS2 * rho + G1 / 6.0 * psi * psi)):
        head = ["SCALARS", name, "float", "1", "LOOKUP_TABLE", "default"]
        vals, keep = _fmt(field, float(field.abs().max()))
        tok += head + vals
        counted += [True] * len(head) + keep
    head = ["VECTORS", "Force", "float"]
    scale = float(torch.maximum(Fx.abs().max(), Fy.abs().max()))
    cols = [_fmt(c, scale) for c in (Fx, Fy, torch.zeros_like(Fx))]
    tok += head + [v for pt in zip(*(c[0] for c in cols)) for v in pt]
    counted += [True] * len(head) + [k for pt in zip(*(c[1] for c in cols)) for k in pt]
    return tok, counted


def dump_count(prm, steps):
    return -(-steps // prm["vtk_freq"]) if prm["vtk_freq"] else 0


def dump_name(it):
    return f"sol_{it:07d}.vtk"
