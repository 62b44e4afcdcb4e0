"""Plain reference of the Fakhari conservative phase-field bubble (D2Q9).

Written from the reference solver's equations (``Abbashub
LBM/apps/Young_Laplace2D.h``, ``LBM_Young_Laplace2D`` :70-371, driver
:456-568) after Fakhari et al. 2017: two D2Q9 distributions, h̄ whose sum
is the phase field φ and ḡ whose sum is the normalised pressure p*.

* The fields of a cell (``update_fields`` :297-370): ρ = ρ_L + φ(ρ_H − ρ_L);
  the isotropic gradient ∇φ = 3 Σ w c φ(r + c) and Laplacian
  ∇²φ = 6 Σ w (φ(r + c) − φ); μ = 4βφ(φ − 1)(φ − ½) − κ∇²φ with β = 12σ/W
  and κ = 3σW/2; n = ∇φ/|∇φ|.
* The force F = μ∇φ − p*(ρ_H − ρ_L)/3 ∇φ + (½ − τ)/τ (S·∇φ)(ρ_H − ρ_L),
  S = Σ_{k≠rest} (ḡ_k − ḡ^eq_k) c c the stress of ḡ against its
  equilibrium at the cell's velocity u.
* The collision (``collide_stream_at`` :217-290), with
  Γ_k − w_k = w_k (3c·u + 4.5(c·u)² − 1.5u²):
  h̄^eq = φΓ_k − ½F^φ_k, F^φ_k = w_k (1 − 4(φ − ½)²)/W c·n, relaxed at
  1/(½ + 3M) and the sharpening term F^φ_k added;
  ḡ^eq = p* w_k + (Γ_k − w_k) − ½F_k, F_k = 3 w_k c·F/ρ, relaxed at 1/τ
  and F_k added; each population pushed to r + c on the periodic box.
* After the streaming the fields are refreshed from the streamed h̄ and ḡ,
  and the velocity u = Σ ḡ c + F/(2ρ), F's stress taken against the
  equilibrium at the previous step's u (the reference reads its stale
  velocity members before it overwrites them, :353-368).
* The initial state (``iniCell`` :141-168, and the driver's one
  ``update_fields`` :520-522): φ = ½ − ½ tanh(2(R − r)/W) about
  (N/2 − ½, N/2 − ½), so the light phase fills the bubble;
  p* = −(φσ/R) ÷ ((ρ + 10⁻¹²)/3), the Laplace jump; h̄ = φw, ḡ = p*w, and
  the velocity of one refresh at u = 0.
* The driver's records (:425-445, :536-552): ``energy.dat`` holds
  ½ Σ|u|² ÷ N² and ``mass.dat`` Σρ, each beside the step; it records at
  every multiple of ``out_freq`` up to ``max_steps`` inclusive, its loop
  running to ``it == max_steps`` (one step past it).  Its dumps: φ, p* as
  ``Pressure``, the velocity with a zero z component, and a zero ``Flag``.

Departures from the published model, all the reference module's (and the
port's): the velocity update's stress uses the stale u (above); both
distributions relax by BGK (the paper also gives a multiple-relaxation-time
ḡ); 1/ρ is taken as 1/(ρ + 10⁻³⁰) and |∇φ|² carries 10⁻³², so that n is 0
where φ is flat; R = N/8, which the case file does not set, as the driver's
``init_bubble`` sets it.

Plain PyTorch in the dtype of the state it is given, on its device; it
imports nothing of the program under test.  It forms one population at a
time, never a stacked 9-wide temporary.
"""
from __future__ import annotations

import numpy as np
import torch

# D2Q9 in the reference module's order, (cx, cy), the rest at k = 4
C = ((-1, 0), (0, -1), (-1, -1), (-1, 1), (0, 0), (1, 0), (0, 1), (1, 1), (1, -1))
W = (1 / 9, 1 / 9, 1 / 36, 1 / 36, 4 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36)
REST = 4
MOVING = [k for k in range(9) if k != REST]
EPS_RHO = 1e-30     # the reference's epsC
EPS_GRAD = 1e-32


def params(cfg: dict) -> dict:
    """The driver's parameters from the case file's keys, with the driver's
    defaults where a key is absent."""
    def num(key, default):
        return float(cfg.get(key, default))

    N = int(num("N", 128))
    sigma, width, tau = num("Sigma", 0.01), num("W", 4.0), num("tau", 0.8)
    rhol, rhoh = num("RhoL", 0.001), num("RhoH", 1.0)
    return {"nx": N, "ny": N, "cells": N * N, "radius": N / 8.0,
            "sigma": sigma, "W": width, "rhol": rhol, "rhoh": rhoh,
            "beta": 12.0 * sigma / width, "kappa": 1.5 * sigma * width,
            "omega_phi": 1.0 / (0.5 + 3.0 * num("M", 0.02)), "omega": 1.0 / tau,
            "viscous": (0.5 - tau) / tau,
            "out_freq": int(num("out_freq", 1000)),
            "vtk_freq": int(num("vtk_freq", 1000))}


def _at(q, c):
    """q at r + c on the periodic box; fields are laid out (y, x)."""
    return torch.roll(q, (-c[1], -c[0]), dims=(0, 1))


def _sum(pops):
    out = pops[0].clone()
    for k in range(1, 9):
        out += pops[k]
    return out


def _fields(h, g, prm):
    """φ, p*, ρ, μ and ∇φ of the distributions."""
    phi = _sum(h)
    dx = torch.zeros_like(phi)
    dy = torch.zeros_like(phi)
    lap = torch.zeros_like(phi)
    for k in MOVING:
        nb = _at(phi, C[k])
        if C[k][0]:
            dx += (3.0 * W[k] * C[k][0]) * nb
        if C[k][1]:
            dy += (3.0 * W[k] * C[k][1]) * nb
        lap += (6.0 * W[k]) * (nb - phi)
    mu = 4.0 * prm["beta"] * phi * (phi - 1.0) * (phi - 0.5) - prm["kappa"] * lap
    rho = prm["rhol"] + (prm["rhoh"] - prm["rhol"]) * phi
    return {"phi": phi, "P": _sum(g), "rho": rho, "mu": mu, "dx": dx, "dy": dy}


def _gamma_minus_w(k, ux, uy, usq):
    cu = C[k][0] * ux + C[k][1] * uy
    return W[k] * (3.0 * cu + 4.5 * cu * cu - usq)


def _force(g, ux, uy, fl, prm):
    """F = μ∇φ + F_p + F_μ, the stress of g taken at the velocity (ux, uy)."""
    usq = 1.5 * (ux * ux + uy * uy)
    sxx = torch.zeros_like(ux)
    sxy = torch.zeros_like(ux)
    syy = torch.zeros_like(ux)
    for k in MOVING:
        cx, cy = C[k]
        neq = g[k] - (W[k] * fl["P"] + _gamma_minus_w(k, ux, uy, usq))
        sxx += (cx * cx) * neq
        sxy += (cx * cy) * neq
        syy += (cy * cy) * neq
    drho = prm["rhoh"] - prm["rhol"]
    fx = fl["mu"] * fl["dx"] - fl["P"] * (drho / 3.0) * fl["dx"] \
        + prm["viscous"] * drho * (sxx * fl["dx"] + sxy * fl["dy"])
    fy = fl["mu"] * fl["dy"] - fl["P"] * (drho / 3.0) * fl["dy"] \
        + prm["viscous"] * drho * (sxy * fl["dx"] + syy * fl["dy"])
    return fx, fy


def _velocity(g, u, fl, prm):
    """u = Σ ḡ c + F/(2ρ), F at the velocity ``u`` the cell held."""
    fx, fy = _force(g, u[0], u[1], fl, prm)
    mx = torch.zeros_like(fx)
    my = torch.zeros_like(fx)
    for k in MOVING:
        if C[k][0]:
            mx += C[k][0] * g[k]
        if C[k][1]:
            my += C[k][1] * g[k]
    rho = fl["rho"] + EPS_RHO
    return torch.stack([mx + fx / (2.0 * rho), my + fy / (2.0 * rho)])


def _collide_stream(h, g, u, fl, prm):
    ux, uy = u[0], u[1]
    fx, fy = _force(g, ux, uy, fl, prm)
    usq = 1.5 * (ux * ux + uy * uy)
    norm = torch.sqrt(fl["dx"] * fl["dx"] + fl["dy"] * fl["dy"] + EPS_GRAD)
    nx, ny = fl["dx"] / norm, fl["dy"] / norm
    phi = fl["phi"]
    sharp = (1.0 - 4.0 * (phi - 0.5) * (phi - 0.5)) / prm["W"]
    inv_rho = 1.0 / (fl["rho"] + EPS_RHO)
    wphi, wg = prm["omega_phi"], prm["omega"]
    h_new, g_new = torch.empty_like(h), torch.empty_like(g)
    for k in range(9):
        cx, cy = C[k]
        gw = _gamma_minus_w(k, ux, uy, usq)
        f_phi = W[k] * sharp * (cx * nx + cy * ny)
        heq = phi * (W[k] + gw) - 0.5 * f_phi
        post_h = h[k] + wphi * (heq - h[k]) + f_phi
        f_k = 3.0 * W[k] * (cx * fx + cy * fy) * inv_rho
        geq = W[k] * fl["P"] + gw - 0.5 * f_k
        post_g = g[k] + wg * (geq - g[k]) + f_k
        # push: what leaves r along c arrives at r + c
        h_new[k] = _at(post_h, (-cx, -cy))
        g_new[k] = _at(post_g, (-cx, -cy))
    return h_new, g_new


def _step(h, g, u, prm):
    h2, g2 = _collide_stream(h, g, u, _fields(h, g, prm), prm)
    return h2, g2, _velocity(g2, u, _fields(h2, g2, prm), prm)


def step(state, prm, n):
    """``n`` steps of ``state = (h, g, u)``: h and g ``(9, ny, nx)``, u
    ``(2, ny, nx)``."""
    h, g, u = state
    for _ in range(n):
        h, g, u = _step(h, g, u, prm)
    return h, g, u


def initial(prm, dtype=torch.float64, device="cpu"):
    """The driver's initial state of the bubble (see the module note),
    built in float64 and cast to ``dtype`` before the refresh."""
    nx, ny, R = prm["nx"], prm["ny"], prm["radius"]
    y = torch.arange(ny, dtype=torch.float64, device=device)[:, None]
    x = torch.arange(nx, dtype=torch.float64, device=device)[None, :]
    r = torch.sqrt((x - (nx / 2.0 - 0.5)) ** 2 + (y - (ny / 2.0 - 0.5)) ** 2)
    phi = 0.5 - 0.5 * torch.tanh(2.0 * (R - r) / prm["W"])
    rho = prm["rhol"] + phi * (prm["rhoh"] - prm["rhol"])
    P = -(phi * prm["sigma"] / R) / ((rho + 1e-12) / 3.0)
    h = torch.stack([W[k] * phi for k in range(9)]).to(dtype)
    g = torch.stack([W[k] * P for k in range(9)]).to(dtype)
    u = torch.zeros((2, ny, nx), dtype=dtype, device=device)
    return h, g, _velocity(g, u, _fields(h, g, prm), prm)


def _energy_mass(state, prm):
    h, _, u = state
    e = 0.5 * (u[0] * u[0] + u[1] * u[1]).sum() / (u.shape[-1] * u.shape[-2])
    rho = prm["rhol"] + (prm["rhoh"] - prm["rhol"]) * _sum(h)
    return float(e), float(rho.sum())


def records(states, prm):
    """The lines the driver writes at each record whose state is given
    (``{it: (h, g, u)}``): ``{file: {line: [it, value]}}``."""
    out = {"energy.dat": {}, "mass.dat": {}}
    for it, state in states.items():
        if it % prm["out_freq"]:
            continue
        e, m = _energy_mass(state, prm)
        line = it // prm["out_freq"]
        out["energy.dat"][line] = [it, e]
        out["mass.dat"][line] = [it, m]
    return out


def record_counts(prm, steps):
    """Lines of each ``.dat`` file after a run of ``steps`` steps: the
    records at 0, out_freq, … up to ``steps`` inclusive."""
    n = steps // prm["out_freq"] + 1 if prm["out_freq"] else 0
    return {"energy.dat": n, "mass.dat": n}


def dump_count(prm, steps):
    return steps // prm["vtk_freq"] + 1 if prm["vtk_freq"] else 0


def dump_name(it):
    return f"sol_{it:07d}.vtk"


# a value under this share of its field's largest is round-off of a
# cancellation, and its digits are not compared
FLOOR = 1e-6


def _fmt(a, scale):
    """C++ ``operator<<(float)`` (6 significant digits) of each value, and
    whether it carries digits above round-off of a field whose largest
    value is ``scale``."""
    v = a.detach().cpu().to(torch.float64).numpy().ravel()
    return (np.char.mod("%g", v.astype(np.float32)).tolist(),
            (np.abs(v) >= FLOOR * scale).tolist())


def vtk_tokens(state, prm, it):
    """The whitespace-separated tokens of the legacy-VTK dump at ``it``: φ
    and p* (``Pressure``) as float scalars, the velocity as a vector with a
    zero z, the ``Flag`` as int zeros, x fastest, spacing 1; and for each
    token whether it is compared."""
    h, g, u = state
    nx, ny = prm["nx"], prm["ny"]
    tok = ["#", "vtk", "DataFile", "Version", "2.0", "iteration", str(it),
           "ASCII", "DATASET", "STRUCTURED_POINTS", "DIMENSIONS", str(nx),
           str(ny), "1", "ORIGIN", "0", "0", "0", "SPACING", "1", "1", "1",
           "POINT_DATA", str(nx * ny)]
    counted = [True] * len(tok)
    for name, field in (("phi", _sum(h)), ("Pressure", _sum(g))):
        head = ["SCALARS", name, "float", "1", "LOOKUP_TABLE", "default"]
        vals, keep = _fmt(field, float(field.abs().max()))
        tok += head + vals
        counted += [True] * len(head) + keep
    head = ["VECTORS", "velocity", "float"]
    scale = float(u.abs().max())
    cols = [_fmt(c, scale) for c in (u[0], u[1], torch.zeros_like(u[0]))]
    tok += head + [v for pt in zip(*(c[0] for c in cols)) for v in pt]
    counted += [True] * len(head) + [k for pt in zip(*(c[1] for c in cols)) for k in pt]
    head = ["SCALARS", "Flag", "int", "1", "LOOKUP_TABLE", "default"]
    tok += head + ["0"] * (nx * ny)
    counted += [True] * (len(head) + nx * ny)
    return tok, counted
