"""Plain reference of the HCZ phase-field Rayleigh–Taylor channel (D2Q9).

Written from the reference solver's equations (``Phase field
model/apps/rayleighTaylor2D.h``): the linear φ → ρ map (:232-235), the
Carnahan–Starling ψ of φ and of ρ (:179-184, :237-242, :374-379), the
isotropic stencils with a solid neighbour's value replaced by the mirrored
node's (:248-310, :467-529), the interfacial and gravity force and the
velocity (:316-337), the total pressure (:452-460), the equilibria with the
Guo-type forcing of f and g and BGK (:552-665), and pull streaming with
on-site bounce-back at the walls y = 0 and y = ny − 1 (:532-549).  The
driver's energy record is ½⟨|u|²⟩ over the fluid cells, scaled by
(dx/dt)², and its spike and bubble positions are the topmost rows at which
φ is at most the mean of the binodal values (:668-708).  The driver's
VTK dump holds φ, the density of the linear map and the solid flag.  Plain
PyTorch on whole tensors, in the dtype of the state it is given; it
imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

# D2Q9 in the reference module's order, rest at k = 4
C = ((-1, 0), (0, -1), (-1, -1), (-1, 1), (0, 0), (1, 0), (0, 1), (1, 1), (1, -1))
W = (1 / 9, 1 / 9, 1 / 36, 1 / 36, 4 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36)
OPP = (5, 6, 7, 8, 4, 0, 1, 2, 3)


def params(cfg: dict) -> dict:
    """The driver's parameters from the case file's keys, with the driver's
    defaults where a key is absent (ν = u_lb·N/Re, the channel N × (4N + 2))."""
    def num(key, default):
        return float(cfg.get(key, default))

    N = int(num("N", 256))
    ulb = num("ulb", 0.04)
    dx = 1.0 / N
    return {"nx": N, "ny": 4 * N + 2, "cells": N * (4 * N + 2),
            "omega": 1.0 / (3.0 * ulb * N / num("Re", 3000.0) + 0.5),
            "phi_l": num("phi_l", 0.251), "phi_g": num("phi_g", 0.024),
            "rho_l": num("rho_l", 0.12), "rho_g": num("rho_g", 0.04),
            "a": num("a", 4.0), "b": num("b", 4.0),
            "kappa": num("kappa", 0.01), "gravity": num("gravity", -6.25e-6),
            "dx": dx, "dt": dx * ulb,
            "out_freq": int(num("out_freq", 3200)),
            "vtk_freq": int(num("vtk_freq", 3200))}


def _fluid(prm, device):
    fluid = torch.ones((prm["ny"], prm["nx"]), dtype=torch.bool, device=device)
    fluid[0] = False
    fluid[-1] = False
    return fluid


def _psi(x, prm):
    """Carnahan–Starling pressure less its ideal part, x/3."""
    rt = prm["b"] * x / 4.0
    p = (x / 3.0) * (1.0 + rt + rt * rt - rt ** 3) / (1.0 - rt) ** 3 - prm["a"] * x * x
    return p - x / 3.0


def _shift(q, cx, cy):
    """q at r + c (rolled; walls are handled by the caller's mirror)."""
    return torch.roll(q, (-cy, -cx), dims=(0, 1))


class _Stencil:
    """Neighbour reads with a solid neighbour's value taken from the
    mirrored node r − c."""

    def __init__(self, fluid):
        self.nb_fluid = [_shift(fluid, cx, cy) for cx, cy in C]

    def values(self, q):
        return [torch.where(self.nb_fluid[k], _shift(q, cx, cy), _shift(q, -cx, -cy))
                for k, (cx, cy) in enumerate(C)]

    def grad(self, q):
        v = self.values(q)
        gx = sum(3.0 * W[k] * cx * v[k] for k, (cx, cy) in enumerate(C) if cx)
        gy = sum(3.0 * W[k] * cy * v[k] for k, (cx, cy) in enumerate(C) if cy)
        return gx, gy

    def lap(self, q):
        v = self.values(q)
        return sum(6.0 * W[k] * (v[k] - q) for k in range(9))


def _macro(f, g, fluid, st, prm):
    phi = f.sum(0)
    rho = prm["rho_g"] + (phi - prm["phi_g"]) / (prm["phi_l"] - prm["phi_g"]) * (
        prm["rho_l"] - prm["rho_g"])
    glx, gly = st.grad(st.lap(phi))
    Fx = prm["kappa"] * rho * glx
    Fy = prm["kappa"] * rho * gly + prm["gravity"] * rho
    mx = sum(cx * g[k] for k, (cx, cy) in enumerate(C) if cx)
    my = sum(cy * g[k] for k, (cx, cy) in enumerate(C) if cy)
    ux = (mx + Fx / 6.0) / (rho / 3.0)
    uy = (my + Fy / 6.0) / (rho / 3.0)
    return phi, rho, ux, uy, Fx, Fy


def _step(f, g, fluid, st, prm):
    phi, rho, ux, uy, Fx, Fy = _macro(f, g, fluid, st, prm)
    grx, gry = st.grad(rho)
    Ex, Ey = st.grad(_psi(rho, prm))
    Hx, Hy = st.grad(_psi(phi, prm))
    P = g.sum(0) + 0.5 * (ux * grx + uy * gry) / 3.0
    om = prm["omega"]
    half = 1.0 - 0.5 * om
    usq = 1.5 * (ux * ux + uy * uy)
    phi_safe = torch.where(fluid, phi, torch.ones_like(phi))
    uF, uE, uH = ux * Fx + uy * Fy, ux * Ex + uy * Ey, ux * Hx + uy * Hy
    mask = fluid.to(f.dtype)
    post_f, post_g = [], []
    for k, (cx, cy) in enumerate(C):
        cu = cx * ux + cy * uy
        poly = 3.0 * cu + 4.5 * cu * cu - usq
        eqf = phi * W[k] * (1.0 + poly)
        eqg = W[k] * (P + rho / 3.0 * poly)
        q = eqf / phi_safe
        fg = half * ((cx * Fx + cy * Fy - uF) * q - (cx * Ex + cy * Ey - uE) * (q - W[k]))
        ff = half * -(cx * Hx + cy * Hy - uH) * 3.0 * q
        post_f.append(((1.0 - om) * f[k] + om * eqf + ff) * mask)
        post_g.append(((1.0 - om) * g[k] + om * eqg + fg) * mask)

    def stream(post):
        out = []
        for k, (cx, cy) in enumerate(C):
            up_fluid = _shift(fluid, -cx, -cy)
            out.append(torch.where(up_fluid, _shift(post[k], -cx, -cy), post[OPP[k]]) * mask)
        return torch.stack(out)

    return stream(post_f), stream(post_g)


def step(state, prm, n):
    """``n`` steps of ``state = (f, g)``."""
    f, g = state
    fluid = _fluid(prm, f.device)
    st = _Stencil(fluid)
    for _ in range(n):
        f, g = _step(f, g, fluid, st, prm)
    return f, g


def _interface(phi, prm, x):
    """Row of the topmost fluid cell of column ``x`` whose φ is at most the
    mean of the binodal values, 0 if none (findInterfaceHeights,
    :668-708)."""
    col = phi[1:-1, x]
    rows = torch.nonzero(col <= 0.5 * (prm["phi_l"] + prm["phi_g"]))
    return int(rows[-1]) + 1 if len(rows) else 0


def records(states, prm):
    """The lines the driver writes at each record whose state is given
    (``{it: (f, g)}``): ``{file: {line: [columns]}}``: the energy, and the
    spike (x = nx/2) and bubble (x = 0) positions.  The velocity file is
    their difference over the cadence; it is counted, not compared."""
    out = {"energy.dat": {}, "spike_bubble_position.dat": {}}
    dx, dt = prm["dx"], prm["dt"]
    for it, (f, g) in states.items():
        if it % prm["out_freq"]:
            continue
        fluid = _fluid(prm, f.device)
        phi, _, ux, uy, _, _ = _macro(f, g, fluid, _Stencil(fluid), prm)
        zero = torch.zeros_like(ux)
        e = 0.5 * (torch.where(fluid, ux, zero) ** 2 + torch.where(fluid, uy, zero) ** 2).sum()
        line = it // prm["out_freq"]
        out["energy.dat"][line] = [it * dt, float(e / fluid.numel()) * dx * dx / (dt * dt)]
        out["spike_bubble_position.dat"][line] = [
            it * dt, _interface(phi, prm, prm["nx"] // 2) * dx, _interface(phi, prm, 0) * dx]
    return out


def record_counts(prm, steps):
    """Lines of each ``.dat`` file after a run of ``steps`` steps."""
    n = -(-steps // prm["out_freq"]) if prm["out_freq"] else 0
    return {"energy.dat": n, "spike_bubble_position.dat": n,
            "spike_bubble_velocity.dat": max(n - 1, 0)}


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
    """The whitespace-separated tokens of the legacy-VTK dump at ``it``:
    φ and the density of the linear map as float32 ``%g``, then the solid
    flag (1 on the walls) as integers, x fastest, on spacing 1/N; and for
    each token whether it is compared (every token but the digits of
    round-off values)."""
    f, _ = state
    phi = f.sum(0)
    rho = prm["rho_g"] + (phi - prm["phi_g"]) / (prm["phi_l"] - prm["phi_g"]) * (
        prm["rho_l"] - prm["rho_g"])
    nx, ny, s = prm["nx"], prm["ny"], f"{prm['dx']:g}"
    tok = ["#", "vtk", "DataFile", "Version", "2.0", "iteration", str(it),
           "ASCII", "DATASET", "STRUCTURED_POINTS", "DIMENSIONS", str(nx),
           str(ny), "1", "ORIGIN", "0", "0", "0", "SPACING", s, s, s,
           "POINT_DATA", str(nx * ny)]
    counted = [True] * len(tok)
    for name, field in (("phi", phi), ("density", rho)):
        head = ["SCALARS", name, "float", "1", "LOOKUP_TABLE", "default"]
        vals, keep = _fmt(field)
        tok += head + vals
        counted += [True] * len(head) + keep
    flag = (~_fluid(prm, f.device)).to(torch.int64).cpu().numpy().ravel()
    head = ["SCALARS", "Flag", "int", "1", "LOOKUP_TABLE", "default"]
    tok += head + [str(v) for v in flag.tolist()]
    counted += [True] * (len(head) + flag.size)
    return tok, counted


def dump_name(it):
    return f"sol_{it:07d}.vtk"
