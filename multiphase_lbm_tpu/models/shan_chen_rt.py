"""Shan–Chen Rayleigh–Taylor variant (ψ = 1 − e^(−ρ), Guo forcing).

JAX re-design of reference
``shan-chen single component model/apps/RayleighTaylor2D.h``: exponential
pseudopotential, cos-perturbed tanh density interface, gravity, and
Guo-style forcing applied *inside* the collision (unlike the velocity-shift
scheme of the other SC modules); the fluid-wall force is present but zeroed
(reference :338-339), and wall-adjacent neighbor reads use the mirrored cell
(reference :260-276).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import eos
from ..core.lattice import D2Q9, Lattice
from ..core.streaming import stream_bounce_back
from ..core.precision import einsum

RHO_FLOOR = 1e-14


@dataclasses.dataclass(frozen=True)
class SCRTParams:
    """Defaults from ``config_RayleighTaylor2D.txt``."""

    omega: float = 1.0
    rhol: float = 1.2
    rhog: float = 0.4
    g: float = -5.0          # fluid-fluid coupling strength
    gravity: float = -1.25e-5

    @property
    def tau(self):
        return 1.0 / self.omega


def density(f):
    return jnp.sum(f, axis=0)


def force_ff(rho, fluid, p: SCRTParams, lattice: Lattice = D2Q9):
    """F = −g ψ_c Σ w_k c_k ψ(ρ_nb) (+ mirrored reads at walls) + gravity·ρ ŷ
    (reference force_ff, :237-293)."""
    psi = eos.psi_exponential(rho)
    axes = tuple(range(rho.ndim))
    shifts = lattice.roll_shifts()
    w, c = lattice.w, lattice.c
    fx = jnp.zeros_like(rho)
    fy = jnp.zeros_like(rho)
    for k in range(lattice.q):
        if not any(c[k]):
            continue
        neg = tuple(-s for s in shifts[k])
        nb_fluid = jnp.roll(fluid, neg, axis=axes)
        fwd = jnp.roll(psi, neg, axis=axes)
        bwd = jnp.roll(psi, shifts[k], axis=axes)   # mirrored ψ at r − c_k
        psi_k = jnp.where(nb_fluid, fwd, bwd)
        if c[k][0]:
            fx = fx + float(w[k] * c[k][0]) * psi_k
        if c[k][1]:
            fy = fy + float(w[k] * c[k][1]) * psi_k
    Fx = -p.g * psi * fx
    Fy = -p.g * psi * fy + p.gravity * rho
    return jnp.stack([Fx, Fy], axis=0)


def step(f, fluid, p: SCRTParams, lattice: Lattice = D2Q9):
    """BGK with Guo forcing at u_eq = u + F/(2ρ) (reference u_eq :392-401,
    collideBgk :369-405), then bounce-back pull streaming."""
    return step_with_gravity(f, fluid, p, p.gravity, lattice)


def step_with_gravity(f, fluid, p: SCRTParams, gravity, lattice: Lattice = D2Q9):
    """Same step with a *traced* gravity (differentiable for calibration /
    inverse problems — autodiff flows through force, collision, streaming)."""
    dtype = f.dtype
    rho = density(f)
    rho_safe = jnp.maximum(rho, RHO_FLOOR)
    c = jnp.asarray(lattice.c, dtype=dtype)
    w = jnp.asarray(lattice.w, dtype=dtype)
    mom = einsum("kd,k...->d...", c, f)
    u = mom / rho_safe[None]
    F = force_ff(rho, fluid, p, lattice)
    # swap the static-gravity contribution for the traced one
    F = F.at[1].add((gravity - p.gravity) * rho)
    ueq = u + 0.5 * F / rho_safe[None]

    cu = einsum("kd,d...->k...", c, ueq)
    usqr = 1.5 * einsum("d...,d...->...", ueq, ueq)
    wk = w.reshape((lattice.q,) + (1,) * rho.ndim)
    feq = rho[None] * wk * (1.0 + 3.0 * cu + 4.5 * cu * cu - usqr[None])

    # Guo source: w_k (1−ω/2) [3(c−u) + 9(c·u)c]·F  (reference :398-399)
    e_uF = einsum("kd,d...->k...", c, F) - einsum("d...,d...->...", ueq, F)[None]
    cF = einsum("kd,d...->k...", c, F)
    src = wk * (1.0 - 0.5 * p.omega) * (3.0 * e_uF + 9.0 * cu * cF)

    post = (1.0 - p.omega) * f + p.omega * feq + src
    post = post * fluid[None].astype(dtype)
    return stream_bounce_back(post, fluid, lattice)


@partial(jax.jit, static_argnames=("p", "lattice", "n_steps"))
def run(f, fluid, p: SCRTParams, n_steps: int, lattice: Lattice = D2Q9):
    def body(carry, _):
        return step(carry, fluid, p, lattice), None
    f, _ = jax.lax.scan(body, f, None, length=n_steps)
    return f


def init_interface(nx, ny, p: SCRTParams, dtype=jnp.float64,
                   lattice: Lattice = D2Q9):
    """Cos-perturbed tanh density interface, heavy on top
    (reference iniLattice, :134-158; width 2.5)."""
    X, Y = np.meshgrid(np.arange(nx, dtype=float), np.arange(ny, dtype=float))
    interface = ny / 2.0 + nx * 0.1 * np.cos(2.0 * np.pi * X / (nx - 1))
    rho = (0.5 * (p.rhol + p.rhog)
           + 0.5 * (p.rhol - p.rhog) * np.tanh((Y - interface) / 5.0))
    w = np.asarray(lattice.w)
    return jnp.asarray(rho[None] * w[:, None, None], dtype)


def geometry_channel(nx, ny):
    fluid = np.ones((ny, nx), dtype=bool)
    fluid[0] = fluid[-1] = False
    return jnp.asarray(fluid)


# ─── diagnostics ───────────────────────────────────────────────────────────
def kinetic_energy(f, fluid, p: SCRTParams, lattice: Lattice = D2Q9):
    """Mean kinetic energy ½⟨|u + F/2ρ|²⟩ over the box (the reference
    RayleighTaylor2D.h driver's computeEnergy → energy.dat log)."""
    rho = density(f)
    rho_safe = jnp.maximum(rho, RHO_FLOOR)
    c = jnp.asarray(lattice.c, dtype=f.dtype)
    u = einsum("kd,k...->d...", c, f) / rho_safe[None]
    F = force_ff(rho, fluid, p, lattice)
    ua = u + 0.5 * F / rho_safe[None]
    e = jnp.sum(jnp.where(fluid[None], ua, 0.0) ** 2)
    return 0.5 * e / fluid.size


def interface_height(rho_host: np.ndarray, fluid_host: np.ndarray,
                     p: SCRTParams):
    """Spike (heavy-finger lowest point, x=0 column) and bubble (light-finger
    highest point, mid column) heights of the cos-perturbed interface, in
    lattice units; mirrors the PF module's findInterfaceHeights semantics
    applied to rho (heavy on top here, so the spike descends)."""
    ny, nx = rho_host.shape
    rho_cut = 0.5 * (p.rhol + p.rhog)
    spike_col = 0          # interface trough is at x=0 (cos maximum)
    bub_col = nx // 2      # crest at x=nx/2
    ys = np.arange(ny)
    fs = fluid_host[:, spike_col]
    heavy_s = (rho_host[:, spike_col] > rho_cut) & fs
    spike = float(ys[heavy_s].min()) if heavy_s.any() else float(ny)
    fb = fluid_host[:, bub_col]
    light_b = (rho_host[:, bub_col] <= rho_cut) & fb
    bubble = float(ys[light_b].max()) if light_b.any() else 0.0
    return spike, bubble
