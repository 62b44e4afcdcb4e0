"""Plain reference of the HCZ phase-field static droplet in 3D (D3Q19).

Written from the reference solver's equations (``Phase field
model/apps/laplace3D.h``, ``LBM_laplace3D`` :115-680, driver :853-952), as
the port's model cites them: the linear φ → ρ map, the Carnahan–Starling ψ
of φ (p_CS(φ) − φ/3) and, in 3D, ψ of ρ taken as P − ρ/3 of the
materialised total pressure (:333-337); the isotropic D3Q19 gradient
3 Σ w c q(r + c) and Laplacian 6 Σ w (q(r + c) − q(r)), with ∇∇²φ the
gradient of the materialised Laplacian; the interfacial force F = κφ∇∇²φ
(plus ρ·gravity on y, 0 in the case file), the velocity u = (Σg c + F/6) ÷
(ρ/3), the total pressure P = Σg − ½u·∇ψφ (:318-330) and E = ∇(P − ρ/3); both
equilibria with the Guo-type forcing, the phase forcing divided by ρ (:608),
BGK, and pull streaming on the fully periodic box.  The driver's record is
the energy ½Σ|u|² ÷ N³, unscaled, beside the time it·dt.

Departures, both the port's (and the JAX package's): the rest population's
forcing uses the general-k formula, and u_z adds F_z/6 where the reference
module writes F_y/6 (a typo there).

Plain PyTorch in the dtype of the state it is given, on its device; it
imports nothing of the program under test.  It computes one population at a
time, never a stacked 19-wide temporary, so that a float64 step at 256³ on
the card holds the state, its successor and about twenty scalar fields.
"""
from __future__ import annotations

import numpy as np
import torch

# D3Q19 in the reference module's order (laplace3D.h:31-55): nine
# negative-half directions, the rest at k = 9, their mirrors; (cx, cy, cz)
C = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (-1, -1, 0), (-1, 1, 0), (-1, 0, -1),
     (-1, 0, 1), (0, -1, -1), (0, -1, 1), (0, 0, 0), (1, 0, 0), (0, 1, 0),
     (0, 0, 1), (1, 1, 0), (1, -1, 0), (1, 0, 1), (1, 0, -1), (0, 1, 1),
     (0, 1, -1))
W = (1 / 18, 1 / 18, 1 / 18, 1 / 36, 1 / 36, 1 / 36, 1 / 36, 1 / 36, 1 / 36,
     1 / 3, 1 / 18, 1 / 18, 1 / 18, 1 / 36, 1 / 36, 1 / 36, 1 / 36, 1 / 36,
     1 / 36)


def params(cfg: dict) -> dict:
    """The driver's parameters from the case file's keys, with the driver's
    defaults where a key is absent (ν = u_lb·N/Re; the droplet's radius is
    N/4, which the driver does not read from the file)."""
    def num(key, default):
        return float(cfg.get(key, default))

    N = int(num("N", 100))
    ulb = num("ulb", 0.01)
    dx = 1.0 / N
    return {"nx": N, "ny": N, "nz": N, "cells": N ** 3,
            "omega": 1.0 / (3.0 * ulb * N / num("Re", 6.0) + 0.5),
            "phi_l": num("phi_l", 0.251), "phi_g": num("phi_g", 0.024),
            "rho_l": num("rho_l", 0.12), "rho_g": num("rho_g", 0.04),
            "a": num("a", 4.0), "b": num("b", 4.0),
            "kappa": num("kappa", 5e-4), "gravity": num("gravity", 0.0),
            "dx": dx, "dt": dx * ulb,
            "out_freq": int(num("out_freq", 100)),
            "vtk_freq": int(num("vtk_freq", 100))}


def _at(q, c):
    """q at r + c on the periodic box; fields are laid out (z, y, x)."""
    cx, cy, cz = c
    return torch.roll(q, (-cz, -cy, -cx), dims=(0, 1, 2))


def _grad(q):
    g = [torch.zeros_like(q) for _ in range(3)]
    for k, c in enumerate(C):
        if any(c):
            v = 3.0 * W[k] * _at(q, c)
            for d in range(3):
                if c[d]:
                    g[d] += c[d] * v
    return g


def _lap(q):
    out = torch.zeros_like(q)
    for k, c in enumerate(C):
        if any(c):
            out += 6.0 * W[k] * (_at(q, c) - q)
    return out


def _psi(x, prm):
    """Carnahan–Starling pressure less its ideal part, x/3."""
    rt = prm["b"] * x / 4.0
    p = (x / 3.0) * (1.0 + rt + rt * rt - rt ** 3) / (1.0 - rt) ** 3 - prm["a"] * x * x
    return p - x / 3.0


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cdot(c, v):
    """c · v for a lattice direction c, adding only its nonzero terms."""
    out = None
    for d in range(3):
        if c[d]:
            t = c[d] * v[d]
            out = t if out is None else out + t
    return out if out is not None else torch.zeros_like(v[0])


def _macro(f, g, prm):
    """φ, ρ, u and F of the populations."""
    phi = f.sum(0)
    rho = prm["rho_g"] + (phi - prm["phi_g"]) / (prm["phi_l"] - prm["phi_g"]) * (
        prm["rho_l"] - prm["rho_g"])
    gl = _grad(_lap(phi))
    F = [prm["kappa"] * phi * gl[0],
         prm["kappa"] * phi * gl[1] + prm["gravity"] * rho,
         prm["kappa"] * phi * gl[2]]
    m = [torch.zeros_like(phi) for _ in range(3)]
    for k, c in enumerate(C):
        for d in range(3):
            if c[d]:
                m[d] += c[d] * g[k]
    u = [(m[d] + F[d] / 6.0) / (rho / 3.0) for d in range(3)]
    return phi, rho, u, F


def _step(f, g, prm):
    phi, rho, u, F = _macro(f, g, prm)
    H = _grad(_psi(phi, prm))                 # ∇ψφ
    P = g.sum(0) - 0.5 * _dot(u, H)
    E = _grad(P - rho / 3.0)                  # ∇ψρ with ψρ = P − ρ/3
    om = prm["omega"]
    half = 1.0 - 0.5 * om
    usq = 1.5 * _dot(u, u)
    uF, uE, uH = _dot(u, F), _dot(u, E), _dot(u, H)
    f_new, g_new = torch.empty_like(f), torch.empty_like(g)
    for k, c in enumerate(C):
        cu = _cdot(c, u)
        poly = 3.0 * cu + 4.5 * cu * cu - usq
        eqf = phi * W[k] * (1.0 + poly)
        eqg = W[k] * (P + rho / 3.0 * poly)
        q = eqf / phi
        fg = half * ((_cdot(c, F) - uF) * q - (_cdot(c, E) - uE) * (q - W[k]))
        ff = half * -(_cdot(c, H) - uH) * 3.0 * eqf / rho
        post_f = (1.0 - om) * f[k] + om * eqf + ff
        post_g = (1.0 - om) * g[k] + om * eqg + fg
        # pull streaming: the population at r comes from r − c
        back = (-c[0], -c[1], -c[2])
        f_new[k] = _at(post_f, back)
        g_new[k] = _at(post_g, back)
    return f_new, g_new


def step(state, prm, n):
    """``n`` steps of ``state = (f, g)``, each ``(19, nz, ny, nx)``."""
    f, g = state
    for _ in range(n):
        f, g = _step(f, g, prm)
    return f, g


def records(states, prm):
    """The lines the driver writes at each record whose state is given
    (``{it: (f, g)}``): ``{"energy.dat": {line: [it·dt, E]}}``."""
    out = {"energy.dat": {}}
    for it, (f, g) in states.items():
        if it % prm["out_freq"]:
            continue
        _, _, u, _ = _macro(f, g, prm)
        e = 0.5 * _dot(u, u).sum() / u[0].numel()
        out["energy.dat"][it // prm["out_freq"]] = [it * prm["dt"], float(e)]
    return out


def record_counts(prm, steps):
    """Lines of each ``.dat`` file after a run of ``steps`` steps."""
    return {"energy.dat": -(-steps // prm["out_freq"]) if prm["out_freq"] else 0}


# a value under this share of its field's largest is round-off of a
# cancellation, and its digits are not compared
FLOOR = 1e-6


def vtk_tokens(state, prm, it):
    """The whitespace-separated tokens of the legacy-VTK dump at ``it``:
    the order parameter φ as float32 ``%g`` (C++ ``operator<<(float)``),
    x fastest, on spacing 1/N; and for each token whether it is compared."""
    f, _ = state
    phi = f.sum(0)
    nx, ny, nz, s = prm["nx"], prm["ny"], prm["nz"], f"{prm['dx']:g}"
    tok = ["#", "vtk", "DataFile", "Version", "2.0", "iteration", str(it),
           "ASCII", "DATASET", "STRUCTURED_POINTS", "DIMENSIONS", str(nx),
           str(ny), str(nz), "ORIGIN", "0", "0", "0", "SPACING", s, s, s,
           "POINT_DATA", str(nx * ny * nz),
           "SCALARS", "phi", "float", "1", "LOOKUP_TABLE", "default"]
    v = phi.detach().cpu().numpy().ravel()
    counted = [True] * len(tok) + (np.abs(v) >= FLOOR * np.abs(v).max()).tolist()
    return tok + np.char.mod("%g", v.astype(np.float32)).tolist(), counted


def dump_count(prm, steps):
    return -(-steps // prm["vtk_freq"]) if prm["vtk_freq"] else 0


def dump_name(it):
    return f"sol_{it:07d}.vtk"
