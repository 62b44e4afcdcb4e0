"""Single-component Shan–Chen pseudopotential solver (D2Q9), plain PyTorch.

Port of ``multiphase_lbm_tpu/models/shan_chen.py`` (reference modules
``shan-chen single component model/apps/laplace2D.h``, ``contactAngle2D.h``
and ``twoLayeredFlow2D.h``).  One time step is a function ``f → f``
(collision with velocity-shift forcing, then bounce-back pull streaming);
:func:`run` is a Python loop over it.  This is the oracle that the CUDA
kernel of :mod:`..ops.sc_fused` is held against, as the XLA path is for the
Pallas kernel.  Solid cells carry zero populations, exactly like the
reference which zeroes them at init and never updates them.

Functions that create tensors take an explicit ``device``; the rest run on
the device of their inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import eos
from ..core.collision import bgk_collide, equilibrium, mrt_collide
from ..core.lattice import D2Q9, Lattice
from ..core.streaming import stream_bounce_back
from ..utils.profiling import upload

RHO_FLOOR = 1e-14  # matches max(density, 1e-14), reference laplace2D.h:159


@dataclasses.dataclass(frozen=True)
class SCParams:
    """Static model parameters; the same fields and defaults as the JAX
    ``SCParams``, following ``config_Laplace2D.txt`` of the reference.
    """

    omega: float = 1.0           # 1/τ
    a: float = 1.0               # Yuan–CS a
    b: float = 4.0               # Yuan–CS b
    R: float = 1.0               # gas constant
    TT0: float = 0.875           # reduced temperature T/Tc
    rhol: float = 0.265
    rhog: float = 0.038
    rho_w: float = 0.12          # virtual wall density (wetting)
    gravity: float = 0.0         # +y body force, ρ-scaled (laplace2D.h:239)
    p_shift: float = 0.0         # ψ² regularisation (twoLayeredFlow2D.h:181-188)
    gx: float = 0.0              # +x body force, ρ-scaled
    gx_u: float = 0.0            # +x body force per NODE, unscaled
    gy_u: float = 0.0            # +y body force per NODE, unscaled
    #   (the layered module adds gx/gy directly to F, twoLayeredFlow2D.h:256-258)
    psi_mode: str = "yuan"       # "yuan" | "const_g"
    G: float = -1.0              # constant coupling for psi_mode="const_g"
    collision: str = "bgk"       # "bgk" | "mrt"
    wall_psi_center_branch: bool = True
    # True  → ψ_w evaluated on the *current node's* G₁ branch
    #         (reference contactAngle2D.h:252-262)
    # False → ψ_w on ρ_w's own branch (reference laplace2D.h:210)

    @property
    def tau(self) -> float:
        return 1.0 / self.omega

    @property
    def T(self) -> float:
        """Absolute EOS temperature TT0 · Tc (reference laplace2D.h:469-470)."""
        return self.TT0 * eos.yuan_Tc(self.a, self.b, self.R)


# ─── macroscopic fields ────────────────────────────────────────────────────
def density(f):
    return f.sum(dim=0)


def momentum_velocity(f, rho, lattice: Lattice = D2Q9):
    """Bare velocity u = Σ f c / ρ (reference laplace2D.h:156-170)."""
    c = torch.as_tensor(lattice.c, dtype=f.dtype, device=f.device)
    mom = torch.einsum("kd,k...->d...", c, f)
    return mom / torch.clamp_min(rho, RHO_FLOOR)[None]


def sc_force(rho, fluid, p: SCParams, lattice: Lattice = D2Q9):
    """Total Shan–Chen force: fluid–fluid + wall wetting + gravity/body force.

    Reference ``laplace2D.h:198-242`` / ``contactAngle2D.h:248-293``:
      F = −G₁c ψ_c [ Σ_k w_k c_k ψ(ρ_nb) |_(fluid nb)  +  ψ_w Σ_k w_k c_k |_(solid nb) ]
      F_y += gravity·ρ,  F_x += gx·ρ.
    """
    rho_w = rho.new_full((), p.rho_w)
    if p.psi_mode == "const_g":
        # constant-G ψ mapping with p_shift (twoLayeredFlow2D.h:183-190):
        # ψ² = 2 (c_s²ρ − (P_eos + p_shift)) / (|G| c_s²), clipped at 0
        def psi_cg(r):
            S = eos.CS2 * r - (eos.yuan_pressure(r, p.a, p.R, p.T) + p.p_shift)
            return torch.sqrt(torch.clamp_min(2.0 * S / (abs(p.G) * eos.CS2), 0.0))
        psi = psi_cg(rho)
        G1c = rho.new_full((), p.G)
        psi_w = psi_cg(rho_w)
    else:
        psi = eos.yuan_psi(rho, p.a, p.R, p.T, p.p_shift)
        G1c = eos.yuan_G1(rho, p.a, p.R, p.T)
        if p.wall_psi_center_branch:
            psi_w = eos.yuan_psi_fixed_branch(rho_w, p.a, p.R, p.T, G1c, p.p_shift)
        else:
            psi_w = eos.yuan_psi(rho_w, p.a, p.R, p.T, p.p_shift)

    dims = tuple(range(rho.ndim))
    shifts = lattice.roll_shifts()
    w = lattice.w
    c = lattice.c
    sum_ff = [torch.zeros_like(rho) for _ in range(lattice.d)]
    sum_bb = [torch.zeros_like(rho) for _ in range(lattice.d)]
    for k in range(lattice.q):
        if not any(c[k]):
            continue
        neg = tuple(-s for s in shifts[k])
        nb_fluid = torch.roll(fluid, neg, dims=dims)
        nb_psi = torch.roll(psi, neg, dims=dims)
        for d in range(lattice.d):
            if c[k][d]:
                wk_ck = float(w[k] * c[k][d])
                sum_ff[d] = sum_ff[d] + wk_ck * torch.where(nb_fluid, nb_psi, 0.0)
                sum_bb[d] = sum_bb[d] + wk_ck * (~nb_fluid).to(rho.dtype)

    F = [-G1c * psi * (sum_ff[d] + psi_w * sum_bb[d]) for d in range(lattice.d)]
    F[0] = F[0] + p.gx * rho + p.gx_u
    F[1] = F[1] + p.gravity * rho + p.gy_u
    return torch.stack(F, dim=0)


def u_actual(f, fluid, p: SCParams, lattice: Lattice = D2Q9):
    """Physically meaningful velocity u + F/(2ρ) (reference laplace2D.h:252-257)."""
    rho = density(f)
    u = momentum_velocity(f, rho, lattice)
    F = sc_force(rho, fluid, p, lattice)
    return u + 0.5 * F / torch.clamp_min(rho, RHO_FLOOR)[None]


def node_pressure(f, p: SCParams):
    """Lattice pressure p = c_s²ρ + G₁/6 ψ² (reference laplace2D.h:308-315)."""
    rho = density(f)
    return eos.yuan_node_pressure(rho, p.a, p.R, p.T, p.p_shift)


# ─── time step ─────────────────────────────────────────────────────────────
def step(f, fluid, p: SCParams, lattice: Lattice = D2Q9):
    """One collide(+velocity-shift forcing)+stream step.

    Collision uses the Shan–Chen velocity shift u_eq = u + τF/ρ
    (reference ``laplace2D.h:245-251``), BGK or MRT relaxation, then pull
    streaming with on-site bounce-back.
    """
    rho = density(f)
    rho_safe = torch.clamp_min(rho, RHO_FLOOR)
    u = momentum_velocity(f, rho, lattice)
    F = sc_force(rho, fluid, p, lattice)
    ueq = u + p.tau * F / rho_safe[None]
    feq = equilibrium(rho, ueq, lattice)
    if p.collision == "mrt":
        # MRT with the pulsatile-module relaxation structure: stress moments
        # at s8 = ω, remaining moments fully relaxed (S=1); SC forcing still
        # enters via the velocity shift in f^eq.
        S = np.ones(9)
        S[7] = S[8] = p.omega
        post = mrt_collide(f, feq, S)
    else:
        post = bgk_collide(f, feq, p.omega)
    # solid cells must contribute zero (their post would be garbage); the
    # stream's fluid gating only protects reads *through* BB, so zero them.
    post = post * fluid[None].to(f.dtype)
    return stream_bounce_back(post, fluid, lattice)


def run(f, fluid, p: SCParams, n_steps: int, lattice: Lattice = D2Q9):
    """Advance ``n_steps`` with :func:`step`; returns a new tensor."""
    for _ in range(n_steps):
        f = step(f, fluid, p, lattice)
    return f


# ─── initial conditions / geometry ─────────────────────────────────────────
def init_droplet(nx, ny, p: SCParams, radius=10.0, center=None,
                 dtype=torch.float32, *, device, lattice: Lattice = D2Q9):
    """Circular droplet at equilibrium-rest populations f_k = ρ w_k.

    Reference ``laplace2D.h:132-145`` (centered droplet) and
    ``contactAngle2D.h:126-137`` (droplet on wall via ``center``).  Built
    in numpy exactly as the JAX version builds it, so both start
    bit-identical.
    """
    if center is None:
        center = (nx / 2.0, ny / 2.0)
    npdtype = torch.empty((), dtype=dtype).numpy().dtype
    X, Y = np.meshgrid(np.arange(nx), np.arange(ny))  # shapes (ny, nx)
    dx = X - center[0]
    dy = Y - center[1]
    rho = np.where(dx * dx + dy * dy <= radius * radius, p.rhol, p.rhog)
    w = np.asarray(lattice.w)
    return upload((rho[None] * w[:, None, None]).astype(npdtype), device)


def geometry_periodic(nx, ny, *, device):
    """All-bulk periodic domain (reference inigeom_Laplace2D)."""
    return torch.ones((ny, nx), dtype=torch.bool, device=device)


def geometry_channel_walls(nx, ny, *, device):
    """Bounce-back walls at y=0 and y=ny−1 (reference inigeom_contactAngle2D)."""
    fluid = torch.ones((ny, nx), dtype=torch.bool, device=device)
    fluid[0, :] = False
    fluid[-1, :] = False
    return fluid


def apply_geometry(f, fluid):
    """Zero populations at solid cells (reference inigeom_* zeroing)."""
    return f * fluid[None].to(f.dtype)


# ─── diagnostics (host-side, run at out_freq cadence) ──────────────────────
def total_mass(f, fluid):
    """Σ ρ over fluid cells (reference totalMass, laplace2D.h:382-393)."""
    return (density(f) * fluid).sum()


def kinetic_energy(f, fluid, p: SCParams, lattice: Lattice = D2Q9):
    """½ ⟨|u_actual|²⟩ over the whole box (reference computeEnergy, :368-380)."""
    u = u_actual(f, fluid, p, lattice)
    e = (torch.where(fluid[None], u, 0.0) ** 2).sum()
    return 0.5 * e / (f.shape[-1] * f.shape[-2])


def contact_angle(rho_host: np.ndarray, fluid_host: np.ndarray, rhol, rhog):
    """Base/height circle-fit contact angle.

    Port of ``contactAngle2D.h:465-529``: base width on the first fluid row
    (scan starts at y=2), height along x = nx/2, circle fit
    R = (4h² + b²)/(8h), θ = atan((b/2)/(R−h)).

    Returns ``(base, height, theta_deg)`` or ``None`` when not detected.
    """
    ny, nx = rho_host.shape
    rho_cut = 0.5 * (rhol + rhog)
    base_y = 2
    while base_y < ny and not fluid_host[base_y, 0]:
        base_y += 1
    if base_y >= ny - 1:
        return None
    xmid = nx // 2
    left = right = xmid
    while left > 0 and rho_host[base_y, (left - 1) % nx] > rho_cut:
        left -= 1
    while right < nx - 1 and rho_host[base_y, (right + 1) % nx] > rho_cut:
        right += 1
    base = max(0, right - left + 1)
    height = 0
    for y in range(base_y, ny):
        if not fluid_host[y, xmid]:
            break
        if rho_host[y, xmid] > rho_cut:
            height += 1
        else:
            break
    if height <= 0 or base <= 1:
        return None
    h, b = float(height), float(base)
    Rc = (4.0 * h * h + b * b) / (8.0 * h)
    theta = np.degrees(np.arctan((0.5 * b) / (Rc - h)))
    if theta < 0.0:
        theta += 180.0
    return base, height, theta


def compute_p_shift(p: SCParams, n_samples: int = 600) -> float:
    """Auto pressure shift so ψ² ≥ 0 across [ρ_g, ρ_l] (reference
    twoLayeredFlow2D.h driver :540-551: max of −S over 601 samples + 1e-12)."""
    r = np.linspace(p.rhog, p.rhol, n_samples + 1)
    S = r / 3.0 - np.asarray(eos.yuan_pressure(r, p.a, p.R, p.T))
    return float(max(0.0, float((-S).max())) + 1e-12)


def init_layers(nx, ny, p: SCParams, h_lower=0.3, w_int=4, dtype=torch.float64,
                *, device, lattice: Lattice = D2Q9):
    """Gas near both walls, liquid in the middle (reference
    twoLayeredFlow2D.h iniLattice_layers:325-344 — despite its comment
    claiming the opposite, the code maps s_liq→ρ_g at the walls)."""
    H = float(ny - 1)
    y_low = min(max(h_lower, 0.0), 0.5) * H
    y_high = H - y_low
    wint = max(1, int(w_int))
    Y = np.arange(ny, dtype=float)[:, None] * np.ones((1, nx))
    s_bottom = 0.5 * (1.0 - np.tanh((Y - y_low) / wint))
    s_top = 0.5 * (1.0 + np.tanh((Y - y_high) / wint))
    s_liq = np.clip(s_bottom + s_top, 0.0, 1.0)
    rho = s_liq * p.rhog + (1.0 - s_liq) * p.rhol
    w = np.asarray(lattice.w)
    npdtype = torch.empty((), dtype=dtype).numpy().dtype
    return upload((rho[None] * w[:, None, None]).astype(npdtype), device)
