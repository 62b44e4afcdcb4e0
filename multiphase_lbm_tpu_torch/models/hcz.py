"""HCZ-style phase-field LBM with Carnahan–Starling EOS (2D D2Q9, 3D D3Q19),
plain PyTorch.

Port of ``multiphase_lbm_tpu/models/hcz.py`` (reference modules
``Phase field model/apps/rayleighTaylor2D.h``, ``twoLayeredFlow2D.h`` and
``laplace3D.h``).  Two distributions: f carries the order parameter φ, g
the pressure; the state is the pair ``(f, g)``.  Every stencil input (φ, ρ,
ψ, ∇²φ, P) is materialised once per step as a whole-lattice field.
:func:`run` is a Python loop over :func:`step_2d` / :func:`step_3d`, the
oracle that the CUDA kernels of :mod:`..ops.hcz_fused` and
:mod:`..ops.hcz3d_fused` are held against.

The JAX module's two documented deviations from the reference hold here
too: the rest-population forcing uses the general-k formula, and the 3D
velocity adds ``forcez/6`` to u_z (the reference's ``forcey/6`` is a typo).
The 2D and 3D schemes differ in more than the lattice: F is κ·ρ·∇∇²φ in 2D
and κ·φ·∇∇²φ in 3D, P's correction is +½u·∇ρ/3 in 2D and −½u·∇ψφ in 3D,
the E field is ∇ψρ in 2D and ∇(P − ρ/3) in 3D, and the phase forcing
divides by φ in 2D and by ρ in 3D.

Functions that create tensors take an explicit ``device``; the rest run on
the device of their inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import eos
from ..core.collision import lattice_tensors
from ..core.lattice import D2Q9, D3Q19, Lattice
from ..core.stencil import grad_of_laplacian, isotropic_gradient
from ..core.streaming import stream_bounce_back


@dataclasses.dataclass(frozen=True)
class HCZParams:
    """The same fields and defaults as the JAX ``HCZParams``
    (``config_rayleighTaylor2D.txt``)."""

    omega: float = 1.0
    phi_l: float = 0.251
    phi_g: float = 0.024
    rho_l: float = 0.12
    rho_g: float = 0.04
    a: float = 4.0
    b: float = 4.0
    kappa: float = 0.01
    gravity: float = 0.0
    gx: float = 0.0          # ρ·gx x-drive (PF twoLayeredFlow2D.h:315)
    Gx_const: float = 0.0    # constant x-force per node (ibid.)


def order_parameter(f):
    return f.sum(dim=0)


def rho_of_phi(phi, p: HCZParams):
    """Linear φ→ρ map (reference rayleighTaylor2D.h:232-235)."""
    return p.rho_g + (phi - p.phi_g) / (p.phi_l - p.phi_g) * (p.rho_l - p.rho_g)


def _per_k(w, ndim):
    return w.reshape((w.shape[0],) + (1,) * ndim)


def macro_2d(f, g, fluid, p: HCZParams, lattice: Lattice = D2Q9):
    """Materialised fields of the 2D scheme:
    ``(φ, ρ, u, P, F, ∇ψρ, ∇ψφ)`` (reference velocity :316-337, total_P
    :452-460, stencils :248-529, all with bounce-back mirroring)."""
    phi = order_parameter(f)
    Pterm = g.sum(dim=0)
    rho = rho_of_phi(phi, p)
    psi_phi = eos.cs_psi(phi, p.a, p.b)
    psi_rho = eos.cs_psi(rho, p.a, p.b)

    glap_phi = grad_of_laplacian(phi, lattice, fluid)
    gpsi_rho = isotropic_gradient(psi_rho, lattice, fluid)
    gpsi_phi = isotropic_gradient(psi_phi, lattice, fluid)
    grho = isotropic_gradient(rho, lattice, fluid)

    # interfacial + body force (rayleighTaylor2D.h:325-328; twoLayered x-drive)
    Fx = p.kappa * rho * glap_phi[0] + p.gx * rho + p.Gx_const
    Fy = p.kappa * rho * glap_phi[1] + p.gravity * rho
    F = torch.stack([Fx, Fy], dim=0)

    _, c = lattice_tensors(lattice, f)
    mom = torch.einsum("kd,k...->d...", c, g)
    u = (mom + F / 6.0) / (rho / 3.0)[None]

    # total pressure with kinetic correction (reference total_P uses ∇ρ, :457)
    P = Pterm + 0.5 * (u * grho).sum(dim=0) / 3.0
    return phi, rho, u, P, F, gpsi_rho, gpsi_phi


def macro_3d(f, g, fluid, p: HCZParams, lattice: Lattice = D3Q19):
    """3D variant (laplace3D.h): F = κ·φ·∇∇²φ; P's correction uses ∇ψφ;
    the E field is ∇(P − ρ/3) of the materialised total pressure P."""
    phi = order_parameter(f)
    Pterm = g.sum(dim=0)
    rho = rho_of_phi(phi, p)
    psi_phi = eos.cs_psi(phi, p.a, p.b)

    glap_phi = grad_of_laplacian(phi, lattice, fluid)
    gpsi_phi = isotropic_gradient(psi_phi, lattice, fluid)

    Fx = p.kappa * phi * glap_phi[0]
    Fy = p.kappa * phi * glap_phi[1] + p.gravity * rho
    Fz = p.kappa * phi * glap_phi[2]
    F = torch.stack([Fx, Fy, Fz], dim=0)

    _, c = lattice_tensors(lattice, f)
    mom = torch.einsum("kd,k...->d...", c, g)
    u = (mom + F / 6.0) / (rho / 3.0)[None]

    # total_P (laplace3D.h:318-330): P_term − ½ u·∇ψφ (no extra 1/3)
    P = Pterm - 0.5 * (u * gpsi_phi).sum(dim=0)
    # E = ∇ψρ with ψρ = P − ρ/3 (laplace3D.h:333-337), materialised
    gpsi_rho = isotropic_gradient(P - rho / 3.0, lattice, fluid)
    return phi, rho, u, P, F, gpsi_rho, gpsi_phi


def _collide_stream(f, g, fluid, p, lattice, macro, phase_divisor):
    """Shared collision (equilibria, Guo-type forcing, BGK) and bounce-back
    streaming of both distributions; ``phase_divisor`` picks φ (2D) or ρ
    (3D) as the phase forcing's divisor."""
    w, c = lattice_tensors(lattice, f)
    ndim = fluid.ndim
    phi, rho, u, P, F, gpsi_rho, gpsi_phi = macro(f, g, fluid, p, lattice)
    wk = _per_k(w, ndim)

    cu = torch.einsum("kd,d...->k...", c, u)
    usqr = 1.5 * (u * u).sum(dim=0)
    eqf = phi[None] * wk * (1.0 + 3.0 * cu + 4.5 * cu * cu - usqr[None])
    eqg = wk * (P[None] + (rho / 3.0)[None] * (3.0 * cu + 4.5 * cu * cu - usqr[None]))

    # (c_k − u) contractions for the Guo-style forcing (:570-597)
    def e_minus_u(v):
        return torch.einsum("kd,d...->k...", c, v) - (u * v).sum(dim=0)[None]

    e_u_F, e_u_E, e_u_gphi = e_minus_u(F), e_minus_u(gpsi_rho), e_minus_u(gpsi_phi)

    half = 1.0 - 0.5 * p.omega
    # φ = 0 at solid cells would poison the masked product (NaN·0 = NaN)
    phi_safe = torch.where(fluid, phi, 1.0)
    eqf_over_phi = eqf / phi_safe[None]
    fg = half * (e_u_F * eqf_over_phi + (-e_u_E) * (eqf_over_phi - wk))
    if phase_divisor == "phi":
        ff = half * (-e_u_gphi) * 3.0 * eqf_over_phi
    else:   # 3D phase forcing divides by ρ (laplace3D.h:608), not φ
        rho_safe = torch.where(fluid, rho, 1.0)
        ff = half * (-e_u_gphi) * 3.0 * eqf / rho_safe[None]

    post_f = (1.0 - p.omega) * f + p.omega * eqf + ff
    post_g = (1.0 - p.omega) * g + p.omega * eqg + fg
    mask = fluid[None].to(f.dtype)
    return (stream_bounce_back(post_f * mask, fluid, lattice),
            stream_bounce_back(post_g * mask, fluid, lattice))


def step_2d(state, fluid, p: HCZParams, lattice: Lattice = D2Q9):
    """One HCZ collide+stream step (reference operator(), :609-665)."""
    f, g = state
    return _collide_stream(f, g, fluid, p, lattice, macro_2d, "phi")


def step_3d(state, fluid, p: HCZParams, lattice: Lattice = D3Q19):
    """One 3D HCZ step (reference laplace3D.h operator(), :627-676)."""
    f, g = state
    return _collide_stream(f, g, fluid, p, lattice, macro_3d, "rho")


def run(state, fluid, p: HCZParams, n_steps: int, lattice: Lattice = D2Q9,
        three_d: bool = False):
    """Advance ``n_steps``; returns a new ``(f, g)``."""
    stepper = step_3d if three_d else step_2d
    for _ in range(n_steps):
        state = stepper(state, fluid, p, lattice)
    return state


# ─── initial conditions / geometry ─────────────────────────────────────────
# Built in numpy (float64) exactly as the JAX versions build them, then cast:
# both packages start bit-identical.
def _to_state(f, g, dtype, device):
    npdtype = torch.empty((), dtype=dtype).numpy().dtype
    return (torch.from_numpy(f.astype(npdtype)).to(device),
            torch.from_numpy(g.astype(npdtype)).to(device))


def init_rayleigh_taylor(nx, ny, p: HCZParams, dtype=torch.float32, *, device,
                         lattice: Lattice = D2Q9):
    """Cos-perturbed tanh interface (reference iniLattice, :155-193).
    Heavy fluid on top (φ → φ_l as y grows)."""
    X, Y = np.meshgrid(np.arange(nx, dtype=float), np.arange(ny, dtype=float))
    interface = ny / 2.0 + nx * 0.1 * np.cos(2.0 * np.pi * X / (nx - 1))
    wwid = 1.25
    phi = (0.5 * (p.phi_l + p.phi_g)
           + 0.5 * (p.phi_l - p.phi_g) * np.tanh((Y - interface) / (2.0 * wwid)))
    rho = p.rho_g + (phi - p.phi_g) / (p.phi_l - p.phi_g) * (p.rho_l - p.rho_g)
    p_rho = eos.carnahan_starling_pressure(rho, p.a, p.b)
    w = np.asarray(lattice.w)
    return _to_state(phi[None] * w[:, None, None], p_rho[None] * w[:, None, None],
                     dtype, device)


def init_layers(nx, ny, p: HCZParams, h_lower=0.3, w_int=2,
                dtype=torch.float32, *, device, lattice: Lattice = D2Q9):
    """Gas near both walls, liquid in the middle (PF twoLayeredFlow2D.h
    iniLattice_layers, :144-190)."""
    H = float(ny - 1)
    y_low = min(max(h_lower, 0.0), 0.5) * H
    y_high = H - y_low
    wint = max(1, int(w_int))
    Y = np.arange(ny, dtype=float)[:, None] * np.ones((1, nx))
    s_bottom = 0.5 * (1.0 - np.tanh((Y - y_low) / wint))
    s_top = 0.5 * (1.0 + np.tanh((Y - y_high) / wint))
    s_liq = np.clip(s_bottom + s_top, 0.0, 1.0)
    s_gas = 1.0 - s_liq
    phi = s_liq * p.phi_g + s_gas * p.phi_l
    rho = s_liq * p.rho_g + s_gas * p.rho_l
    p_rho = eos.carnahan_starling_pressure(rho, p.a, p.b)
    w = np.asarray(lattice.w)
    return _to_state(phi[None] * w[:, None, None], p_rho[None] * w[:, None, None],
                     dtype, device)


def init_droplet_3d(nx, ny, nz, p: HCZParams, radius=None, dtype=torch.float32,
                    *, device, lattice: Lattice = D3Q19):
    """tanh sphere (laplace3D.h iniLattice, :171-213): φ and p_th
    interpolated between binodal values by the smooth Heaviside."""
    if radius is None:
        radius = 0.25 * nx
    xc, yc, zc = nx / 2.0, ny / 2.0, nz / 2.0
    Z, Y, X = np.meshgrid(np.arange(nz, dtype=float),
                          np.arange(ny, dtype=float),
                          np.arange(nx, dtype=float), indexing="ij")
    delta = np.sqrt((X - xc) ** 2 + (Y - yc) ** 2 + (Z - zc) ** 2) - radius
    wH = 0.5 * (1.0 - np.tanh(delta / 1.0))
    pth_l = float(eos.carnahan_starling_pressure(np.float64(p.phi_l), p.a, p.b))
    pth_g = float(eos.carnahan_starling_pressure(np.float64(p.phi_g), p.a, p.b))
    phi = p.phi_g + wH * (p.phi_l - p.phi_g)
    pth = pth_g + wH * (pth_l - pth_g)
    w = np.asarray(lattice.w)
    return _to_state(phi[None] * w[:, None, None, None],
                     pth[None] * w[:, None, None, None], dtype, device)


def geometry_channel(nx, ny, *, device):
    """Walls at y=0 and y=ny−1 (reference inigeom_rayleighTaylor2D, :802-820)."""
    fluid = torch.ones((ny, nx), dtype=torch.bool, device=device)
    fluid[0] = False
    fluid[-1] = False
    return fluid


def geometry_periodic_3d(nx, ny, nz, *, device):
    """All-bulk (laplace3D inigeom disables its wall branch, :830-849)."""
    return torch.ones((nz, ny, nx), dtype=torch.bool, device=device)


def apply_geometry(state, fluid):
    f, g = state
    m = fluid[None].to(f.dtype)
    return (f * m, g * m)


# ─── diagnostics ───────────────────────────────────────────────────────────
def interface_heights(phi_host: np.ndarray, p: HCZParams, ny_fluid=None):
    """Spike/bubble y positions (reference findInterfaceHeights, :668-708):
    topmost y (scanning down from ny−2) where φ ≤ φ_mid, at x=0 ('bubble'
    in the reference) and x=nx/2 ('spike').  ``ny_fluid`` bounds the scan
    when the lattice carries extra solid rows above the channel."""
    ny, nx = phi_host.shape
    if ny_fluid is not None:
        ny = ny_fluid
    phi_mid = 0.5 * (p.phi_l + p.phi_g)

    def scan_col(x):
        col = phi_host[1:ny - 1, x]
        below = np.nonzero(col <= phi_mid)[0]
        return int(below[-1]) + 1 if below.size else 0

    bubble_y = scan_col(0)
    spike_y = scan_col(nx // 2)
    return spike_y, bubble_y


def kinetic_energy(state, fluid, p: HCZParams, lattice: Lattice = D2Q9,
                   three_d: bool = False):
    f, g = state
    macro = macro_3d if three_d else macro_2d
    _, _, u, _, _, _, _ = macro(f, g, fluid, p, lattice)
    e = (torch.where(fluid[None], u, 0.0) ** 2).sum()
    return 0.5 * e / fluid.numel()


def total_phase_mass(state):
    return state[0].sum()
