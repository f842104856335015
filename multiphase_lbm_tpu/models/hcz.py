"""HCZ-style phase-field LBM with Carnahan–Starling EOS (2D D2Q9, 3D D3Q19).

JAX re-design of the reference modules
``Phase field model/apps/rayleighTaylor2D.h`` (Rayleigh–Taylor instability),
``twoLayeredFlow2D.h`` (body-force-driven layered channel) and
``laplace3D.h`` (D3Q19 droplet).  Two distributions: f carries the order
parameter φ, g the pressure.

Key restructuring (SURVEY §3.3): the reference recomputes neighbor
Laplacians *inside* the gradient-of-Laplacian for every cell (an effective
5×5 recompute explosion; the 3D module even recurses through
``total_P → velocity → grad_lap_phi`` per neighbor).  Here every stencil
input (φ, ρ, ψ, ∇²φ, P) is materialised once per step as a whole-lattice
field; the bounce-back-aware mirrored stencils then reproduce the reference
values exactly at a fraction of the flops.

Two faithful deviations, both documented:
* the reference's rest-population forcing flips the sign of the
  (u·∇ψρ)-term relative to its own general-k formula
  (rayleighTaylor2D.h:654-656 vs :583-586); we use the general formula for
  all k (difference is O(u³·w₀·usqr)).
* the 3D module's velocity helper adds ``forcey/6`` to u_z
  (laplace3D.h:302-304, an evident typo); we add ``forcez/6``.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import eos
from ..core.lattice import D2Q9, D3Q19, Lattice
from ..core.stencil import grad_of_laplacian, isotropic_gradient
from ..core.streaming import stream_bounce_back
from ..core.precision import einsum


@dataclasses.dataclass(frozen=True)
class HCZParams:
    """Defaults from ``config_rayleighTaylor2D.txt``."""

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
    return jnp.sum(f, axis=0)


def rho_of_phi(phi, p: HCZParams):
    """Linear φ→ρ map (reference rayleighTaylor2D.h:232-235)."""
    return p.rho_g + (phi - p.phi_g) / (p.phi_l - p.phi_g) * (p.rho_l - p.rho_g)


def _per_k(w, q, ndim):
    return w.reshape((q,) + (1,) * ndim)


def macro_2d(f, g, fluid, p: HCZParams, lattice: Lattice = D2Q9):
    """Materialised macroscopic fields of the 2D scheme: φ, ρ, u, P and the
    stencil fields (∇ψρ, ∇ψφ, ∇∇²φ, ∇ρ).

    Reference per-cell versions: velocity :316-337, total_P :452-460,
    stencils :248-529 (all with BB mirroring)."""
    phi = order_parameter(f)
    Pterm = jnp.sum(g, axis=0)
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
    F = jnp.stack([Fx, Fy], axis=0)

    c = jnp.asarray(lattice.c, dtype=f.dtype)
    mom = einsum("kd,k...->d...", c, g)
    u = (mom + F / 6.0) / (rho / 3.0)[None]

    # total pressure with kinetic correction (reference total_P uses ∇ρ, :457)
    P = Pterm + 0.5 * einsum("d...,d...->...", u, grho) / 3.0
    return phi, rho, u, P, F, gpsi_rho, gpsi_phi


def step_2d(state, fluid, p: HCZParams, lattice: Lattice = D2Q9):
    """One fused HCZ collide+stream step (reference operator(), :609-665)."""
    f, g = state
    dtype = f.dtype
    w = jnp.asarray(lattice.w, dtype=dtype)
    c = jnp.asarray(lattice.c, dtype=dtype)
    q = lattice.q
    ndim = fluid.ndim

    phi, rho, u, P, F, gpsi_rho, gpsi_phi = macro_2d(f, g, fluid, p, lattice)
    wk = _per_k(w, q, ndim)

    cu = einsum("kd,d...->k...", c, u)
    usqr = 1.5 * einsum("d...,d...->...", u, u)
    eqf = phi[None] * wk * (1.0 + 3.0 * cu + 4.5 * cu * cu - usqr[None])
    eqg = wk * (P[None] + (rho / 3.0)[None] * (3.0 * cu + 4.5 * cu * cu - usqr[None]))

    # (c_k − u) contractions for the Guo-style forcing (:570-597)
    e_u_F = einsum("kd,d...->k...", c, F) - einsum("d...,d...->...", u, F)[None]
    e_u_E = (einsum("kd,d...->k...", c, gpsi_rho)
             - einsum("d...,d...->...", u, gpsi_rho)[None])
    e_u_gphi = (einsum("kd,d...->k...", c, gpsi_phi)
                - einsum("d...,d...->...", u, gpsi_phi)[None])

    half = 1.0 - 0.5 * p.omega
    # φ=0 at solid cells would poison the masked product (NaN·0 = NaN)
    phi_safe = jnp.where(fluid, phi, 1.0)
    eqf_over_phi = eqf / phi_safe[None]
    fg = half * (e_u_F * eqf_over_phi + (-e_u_E) * (eqf_over_phi - wk))
    ff = half * (-e_u_gphi) * 3.0 * eqf_over_phi

    post_f = (1.0 - p.omega) * f + p.omega * eqf + ff
    post_g = (1.0 - p.omega) * g + p.omega * eqg + fg
    mask = fluid[None].astype(dtype)
    f2 = stream_bounce_back(post_f * mask, fluid, lattice)
    g2 = stream_bounce_back(post_g * mask, fluid, lattice)
    return (f2, g2)


def macro_3d(f, g, fluid, p: HCZParams, lattice: Lattice = D3Q19):
    """3D variant (laplace3D.h): F = κ·φ·∇∇²φ; P correction uses ∇ψφ;
    E-field is ∇(P − ρ/3) with P the materialised total pressure."""
    phi = order_parameter(f)
    Pterm = jnp.sum(g, axis=0)
    rho = rho_of_phi(phi, p)
    psi_phi = eos.cs_psi(phi, p.a, p.b)

    glap_phi = grad_of_laplacian(phi, lattice, fluid)
    gpsi_phi = isotropic_gradient(psi_phi, lattice, fluid)

    Fx = p.kappa * phi * glap_phi[0]
    Fy = p.kappa * phi * glap_phi[1] + p.gravity * rho
    Fz = p.kappa * phi * glap_phi[2]
    F = jnp.stack([Fx, Fy, Fz], axis=0)

    c = jnp.asarray(lattice.c, dtype=f.dtype)
    mom = einsum("kd,k...->d...", c, g)
    u = (mom + F / 6.0) / (rho / 3.0)[None]

    # total_P (laplace3D.h:318-330): P_term − ½ u·∇ψφ (no extra 1/3)
    P = Pterm - 0.5 * einsum("d...,d...->...", u, gpsi_phi)
    # E = ∇ψρ with ψρ = P − ρ/3 (laplace3D.h:333-337), materialised
    psi_rho3 = P - rho / 3.0
    gpsi_rho = isotropic_gradient(psi_rho3, lattice, fluid)
    return phi, rho, u, P, F, gpsi_rho, gpsi_phi


def step_3d(state, fluid, p: HCZParams, lattice: Lattice = D3Q19):
    """One 3D HCZ step (reference laplace3D.h operator(), :627-676)."""
    f, g = state
    dtype = f.dtype
    w = jnp.asarray(lattice.w, dtype=dtype)
    c = jnp.asarray(lattice.c, dtype=dtype)
    q = lattice.q
    ndim = fluid.ndim

    phi, rho, u, P, F, gpsi_rho, gpsi_phi = macro_3d(f, g, fluid, p, lattice)
    wk = _per_k(w, q, ndim)

    cu = einsum("kd,d...->k...", c, u)
    usqr = 1.5 * einsum("d...,d...->...", u, u)
    eqf = phi[None] * wk * (1.0 + 3.0 * cu + 4.5 * cu * cu - usqr[None])
    eqg = wk * (P[None] + (rho / 3.0)[None] * (3.0 * cu + 4.5 * cu * cu - usqr[None]))

    e_u_F = einsum("kd,d...->k...", c, F) - einsum("d...,d...->...", u, F)[None]
    e_u_E = (einsum("kd,d...->k...", c, gpsi_rho)
             - einsum("d...,d...->...", u, gpsi_rho)[None])
    e_u_gphi = (einsum("kd,d...->k...", c, gpsi_phi)
                - einsum("d...,d...->...", u, gpsi_phi)[None])

    half = 1.0 - 0.5 * p.omega
    phi_safe = jnp.where(fluid, phi, 1.0)
    rho_safe = jnp.where(fluid, rho, 1.0)
    eqf_over_phi = eqf / phi_safe[None]
    fg = half * (e_u_F * eqf_over_phi + (-e_u_E) * (eqf_over_phi - wk))
    # 3D phase forcing divides by ρ (laplace3D.h:608), not φ
    ff = half * (-e_u_gphi) * 3.0 * eqf / rho_safe[None]

    post_f = (1.0 - p.omega) * f + p.omega * eqf + ff
    post_g = (1.0 - p.omega) * g + p.omega * eqg + fg
    mask = fluid[None].astype(dtype)
    f2 = stream_bounce_back(post_f * mask, fluid, lattice)
    g2 = stream_bounce_back(post_g * mask, fluid, lattice)
    return (f2, g2)


@partial(jax.jit, static_argnames=("p", "lattice", "n_steps", "three_d", "unroll"))
def run(state, fluid, p: HCZParams, n_steps: int, lattice: Lattice = D2Q9,
        three_d: bool = False, unroll: int = 1):
    stepper = step_3d if three_d else step_2d

    def body(carry, _):
        return stepper(carry, fluid, p, lattice), None

    state, _ = jax.lax.scan(body, state, None, length=n_steps, unroll=unroll)
    return state


# ─── initial conditions / geometry ─────────────────────────────────────────
def init_rayleigh_taylor(nx, ny, p: HCZParams, dtype=jnp.float32,
                         lattice: Lattice = D2Q9):
    """Cos-perturbed tanh interface (reference iniLattice, :155-193).
    Heavy fluid on top (φ → φ_l as y grows)."""
    X, Y = np.meshgrid(np.arange(nx, dtype=float), np.arange(ny, dtype=float))
    interface = ny / 2.0 + nx * 0.1 * np.cos(2.0 * np.pi * X / (nx - 1))
    wwid = 1.25
    phi = (0.5 * (p.phi_l + p.phi_g)
           + 0.5 * (p.phi_l - p.phi_g) * np.tanh((Y - interface) / (2.0 * wwid)))
    rho = p.rho_g + (phi - p.phi_g) / (p.phi_l - p.phi_g) * (p.rho_l - p.rho_g)
    p_rho = np.asarray(eos.carnahan_starling_pressure(rho, p.a, p.b))
    w = np.asarray(lattice.w)
    f = phi[None] * w[:, None, None]
    g = p_rho[None] * w[:, None, None]
    return (jnp.asarray(f, dtype), jnp.asarray(g, dtype))


def init_layers(nx, ny, p: HCZParams, h_lower=0.3, w_int=2,
                dtype=jnp.float32, lattice: Lattice = D2Q9):
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
    p_rho = np.asarray(eos.carnahan_starling_pressure(rho, p.a, p.b))
    w = np.asarray(lattice.w)
    f = phi[None] * w[:, None, None]
    g = p_rho[None] * w[:, None, None]
    return (jnp.asarray(f, dtype), jnp.asarray(g, dtype))


def init_droplet_3d(nx, ny, nz, p: HCZParams, radius=None, dtype=jnp.float32,
                    lattice: Lattice = D3Q19):
    """tanh sphere (laplace3D.h iniLattice, :171-213): φ and p_th interpolated
    between binodal values by the smooth Heaviside."""
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
    f = phi[None] * w[:, None, None, None]
    g = pth[None] * w[:, None, None, None]
    return (jnp.asarray(f, dtype), jnp.asarray(g, dtype))


def geometry_channel(nx, ny):
    """Walls at y=0 and y=ny−1 (reference inigeom_rayleighTaylor2D, :802-820)."""
    fluid = np.ones((ny, nx), dtype=bool)
    fluid[0] = fluid[-1] = False
    return jnp.asarray(fluid)


def geometry_periodic_3d(nx, ny, nz):
    """All-bulk (laplace3D inigeom disables its wall branch, :830-849)."""
    return jnp.ones((nz, ny, nx), dtype=bool)


def apply_geometry(state, fluid):
    f, g = state
    m = fluid[None].astype(f.dtype)
    return (f * m, g * m)


# ─── diagnostics ───────────────────────────────────────────────────────────
def interface_heights(phi_host: np.ndarray, p: HCZParams):
    """Spike/bubble y positions (reference findInterfaceHeights, :668-708):
    topmost y (scanning down from ny−2) where φ ≤ φ_mid, at x=0 (named
    'bubble' in the reference) and x=nx/2 ('spike')."""
    ny, nx = phi_host.shape
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
    e = jnp.sum(jnp.where(fluid[None], u, 0.0) ** 2)
    return 0.5 * e / fluid.size


def total_phase_mass(state):
    return jnp.sum(state[0])
