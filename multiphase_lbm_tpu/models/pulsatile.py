"""Pulsatile blood flow in a deformable 2D vessel (D2Q9 MRT, pressure form).

JAX re-design of reference ``Abbashub LBM/apps/PulsatileBloodFlow2D.h``:
incompressible pressure-form equilibrium, MRT (or BGK) collision, Zou/He
pulsatile pressure inlet/outlet, Bouzidi quadratic curved bounce-back on two
moving walls, and a pressure-driven deformable vessel with per-step geometry
rebuild and fresh-fluid-node seeding.

Everything — wall ODE, implicit-geometry field Fobj, border-coefficient
extraction, Bouzidi, reseeding — runs on-device inside one jitted step (no
host round trips), replacing the reference's serial column marches and
data-dependent border lists with closed-form per-column Δ fields applied via
row one-hot masks (SURVEY §7 hard-part #1/#2).

Validated bit-near-exact against an instrumented build of the C++ reference
(per-step population dumps): collision, Bouzidi Δ extraction and application,
streaming, Zou/He, wall motion and fresh-node seeding all reproduce the C++
to ~1e-9 (f64) over tens of steps, including four non-obvious reference
behaviors replicated deliberately:
* the ping-pong parity quirk (collisions read the previous *post-collision*
  buffer, see PulsatileState);
* the k=0-skipping momentum sum of the regular macro sweep vs the full first
  moment of the fresh-node refresh;
* sequential fresh-node seeding whose ring-search fallback reads neighbours
  filled earlier in the same sweep (x-then-y order);
* the bottom-wall-before-top-wall Bouzidi application order (top-wall links
  can sample bottom-wall border cells in narrow passages).
Over very long runs the near-closed inlet region is chaotic (staircase wall
decisions amplify FP-association noise), so full-run agreement is
statistical rather than bitwise.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.collision import bgk_collide, mrt_collide, pressure_equilibrium
from ..core.lattice import D2Q9, EX_I, EY_I, JB_I, K_FROM_I
from ..core.precision import einsum


@dataclasses.dataclass(frozen=True)
class PulsatileParams:
    """Driver constants (reference PulsatileBloodFlow2D.h:740-751) and the
    derived quantities of Setup_Simulation_Parameters (:152-172)."""

    nx: int
    ny: int
    tau: float = 0.75
    s5: float = 1.0
    alpha: float = 0.01
    deformable: bool = True
    is_severed: bool = True
    p0_in: float = 0.20
    p0_out: float = 0.19
    t_beat: int = 0          # 0 → max(1, nx)
    hsize: int = 1
    collision: str = "mrt"   # "mrt" | "bgk"
    # True reproduces the reference's momentum sweep verbatim: k runs 1..8
    # in module ordering (:224), OMITTING k=0 (the W direction, c=(−1,0))
    # — not the rest direction, which sits at k=4 here (it is k=0 only in
    # the "Abbas I" ordering; a classic ordering mix-up).  Because the
    # momentum moments relax at s=1 toward the equilibrium built from this
    # offset velocity, the quirk FEEDS BACK into the dynamics (a bulk
    # velocity bias of order 3·g₀/ρ₀ per step until g₀ self-cancels).
    # False restores the full first moment — the physics mode validated
    # against analytic Poiseuille/Womersley channel flow
    # (validation/womersley.py).  Parity/golden tests require True.
    momentum_quirk: bool = True
    # True reproduces the reference's ping-pong aliasing verbatim: the
    # pull-stream writes into gin and the parity then flips, so every
    # collision reads the previous POST-COLLISION buffer while the
    # equilibrium comes from the streamed macro fields (see
    # PulsatileState).  Round-5 bisection (2026-08-18) showed this
    # aliasing — not the Zou/He corner rows — is what makes the
    # true-moment mode blow up: with momentum_quirk=False the aliased
    # dynamics grows a wall-wide boundary mode along the Bouzidi walls
    # (e^{t/30} at 61×24, independent of collision operator, wall offset
    # and corner treatment; a channel with NO pressure columns at all
    # still diverges), while reading the streamed buffer — standard
    # collide-stream LBM — is stable for ≥10 beats.  The biased Ux of the
    # momentum quirk happens to damp the aliased mode, which is why the
    # reference configuration survives.  None → follows momentum_quirk,
    # so the parity mode is bit-identical and the physics mode is stable
    # out of the box.
    pingpong_quirk: bool | None = None
    # True feeds the I-ordered Lallemand–Luo CONVERT matrix k-ordered
    # population vectors, exactly like the reference's MRT_Collision
    # (:509-541) — a basis scramble that is NOT y-mirror-equivariant
    # (measured round 5: a mirrored rigid channel decollides differently
    # by ~1e-4/step, skewing the steady channel profile ~40% toward the
    # bottom wall).  False uses the consistent k-ordered basis
    # (core.collision.MRT_M_K), restoring exact mirror symmetry.  None →
    # follows momentum_quirk.
    mrt_basis_quirk: bool | None = None
    # Zou/He corner-node closure at the rows where the pressure columns
    # meet the Bouzidi walls.  The reference applies the BULK Zou/He
    # formulas on every row between yr1 and yr2 (:618-669) including the
    # wall-adjacent ones; the closure replaces the two corner rows per
    # column with the classical no-slip corner node (Zou & He 1997 §V):
    # u = 0, P from the column waveform, unknown populations by
    # non-equilibrium bounce-back with the two buried diagonals closing
    # the pressure sum.  Not required for stability once pingpong_quirk
    # is off (measured: both variants stable 4000 steps at 61×24), but it
    # reduces corner noise (max|Uy| 5.3e-3 → 4.9e-3) and removes the
    # formally undefined use of solid-row tangential populations.  None →
    # enabled exactly when momentum_quirk is False.
    zou_he_corner_closure: bool | None = None

    @property
    def pingpong(self) -> bool:
        if self.pingpong_quirk is None:
            return self.momentum_quirk
        return self.pingpong_quirk

    @property
    def mrt_basis_scrambled(self) -> bool:
        if self.mrt_basis_quirk is None:
            return self.momentum_quirk
        return self.mrt_basis_quirk

    @property
    def corner_closure(self) -> bool:
        if self.zou_he_corner_closure is None:
            return not self.momentum_quirk
        return self.zou_he_corner_closure

    @property
    def rho0(self):
        return 1.0 / self.hsize ** 3

    @property
    def S(self):
        s8 = 1.0 / self.tau
        return (1.0, 1.0, 1.0, 1.0, self.s5, 1.0, self.s5, s8, s8)

    # ---- Setup_Simulation_Parameters (:152-172) ----
    @property
    def beat(self):
        return self.t_beat if self.t_beat > 0 else max(1, self.nx)

    @property
    def omega(self):
        return 2.0 * math.pi / float(self.beat)

    @property
    def pin(self):
        return 0.02 if self.is_severed else self.p0_in

    @property
    def pout(self):
        return 0.0 if self.is_severed else self.p0_out

    @property
    def p_tissue(self):
        return self.pin

    @property
    def p_osc(self):
        posc = self.pin - self.pout
        return posc * 0.1 if self.is_severed else posc

    @property
    def t_propagation(self):
        return int((self.nx - 1.0) * math.sqrt(3.0) - 1) * self.hsize

    @property
    def t_start(self):
        return 2 * self.t_propagation

    @property
    def t_sever(self):
        return 0

    @property
    def y0(self):
        return (self.ny - 1) // 2

    @property
    def yc(self):
        """Channel center Y0 + 0.5 used by the geometry formulas."""
        return self.y0 + 0.5


class PulsatileState(NamedTuple):
    """Two population buffers reproduce the reference's ping-pong semantics
    EXACTLY (PulsatileBloodFlow2D.h:764-791): because the pull-stream writes
    into the *gin* buffer and the parity then flips, every collision reads
    the PREVIOUS step's post-collision/post-Bouzidi buffer (``g_coll``),
    while the macroscopic fields driving the equilibrium come from the
    streamed/Zou-He/reseeded buffer (``g_stream``).  The streamed buffer
    also supplies the content of solid cells during the next streaming."""

    g_coll: jnp.ndarray    # (9, ny, nx) next collision's distribution input
    g_stream: jnp.ndarray  # (9, ny, nx) streamed state (macro + solid source)
    yr1: jnp.ndarray       # (nx,) bottom wall position
    yr2: jnp.ndarray       # (nx,) top wall position
    P: jnp.ndarray         # (ny, nx)
    Ux: jnp.ndarray
    Uy: jnp.ndarray
    F: jnp.ndarray         # Fobj with halo columns: (ny+2, nx+2), F[Y+1, X+1]
    fluid: jnp.ndarray     # (ny, nx) bool


# ───────────────────────── geometry: Fobj and flags ────────────────────────
def fobj_from_walls(yr1, yr2, p: PulsatileParams):
    """Implicit geometry field with halo (reference
    Initialize_Fobj_for_Vessel_Walls, :275-285): for Y ≤ Y0 use the bottom
    wall, else the top wall; halo columns are linear extrapolations."""
    ny, nx = p.ny, p.nx
    yc = p.yc
    Y = jnp.arange(-1, ny + 1, dtype=yr1.dtype)            # (ny+2,)
    denom = Y - yc
    lower = (yr1[None, :] - yc) / denom[:, None]           # (ny+2, nx)
    upper = (yr2[None, :] - yc) / denom[:, None]
    body = jnp.where((Y[:, None] <= p.y0), lower, upper)
    left = 2.0 * body[:, 0] - body[:, 1]
    right = 2.0 * body[:, -1] - body[:, -2]
    return jnp.concatenate([left[:, None], body, right[:, None]], axis=1)


def flags_from_fobj(F, p: PulsatileParams):
    """bulk where F ≥ 1 (reference :282-284)."""
    return F[1:-1, 1:-1] >= 1.0


# ───────────────────────── border Δ extraction ─────────────────────────────
def _find_delta(mA, mB, Y1):
    """Δ = max(0, 1 − |Y1/(mA − mB)|) (reference Find_Delta, :288-290)."""
    return jnp.maximum(0.0, 1.0 - jnp.abs(Y1 / (mA - mB)))


def border_deltas(F, yr1, yr2, p: PulsatileParams):
    """Dense per-cell per-I-direction Bouzidi Δ field (8, ny, nx), sentinel 2.

    Vectorised port of Update_Boundary_Nodes_{Bottom,Top} (:294-382): each
    column contributes one *main* border node (the solid cell just outside
    the wall) with up to five Δ entries, plus a *jump* node when the border
    row changes between adjacent columns.  I-direction slots follow the
    reference's D[0..7] = I−1 convention (I: 1=E..8=SE).
    """
    ny, nx = p.ny, p.nx
    dt = yr1.dtype
    rows = jnp.arange(ny, dtype=jnp.int32)[:, None]        # (ny, 1)
    cols = jnp.arange(nx)

    def fluid_at(Xoff_rows, Yrow):                         # F(X+1+dx, Y+1) ≥ 1
        # gather F at (Yrow+1, X+1+Xoff) for every column X; clamp X index
        Xi = jnp.clip(cols + 1 + Xoff_rows, 0, nx + 1)
        return F[Yrow + 1, Xi] >= 1.0

    def one_wall(D, yr, bottom: bool):
        # main border row per column (:297, :341)
        if bottom:
            Yx0 = jnp.floor(yr).astype(jnp.int32)
            fl0 = F[Yx0 + 1, cols + 1] >= 1.0
            Yx = jnp.where(fl0, Yx0 - 1, Yx0)
        else:
            Yx0 = jnp.ceil(yr).astype(jnp.int32)
            fl0 = F[Yx0 + 1, cols + 1] >= 1.0
            Yx = jnp.where(fl0, Yx0 + 1, Yx0)
        Yx = jnp.clip(Yx, 0, ny - 1)

        yr_w = jnp.roll(yr, 1)     # yr[X-1]
        yr_e = jnp.roll(yr, -1)    # yr[X+1]
        slope_e = yr_e - yr        # yr[X+1]-yr[X]
        slope_w = yr - yr_w        # yr[X]-yr[X-1]
        dist = yr - Yx.astype(dt)

        first = cols == 0
        last = cols == nx - 1
        interior_e = ~last          # directions using X+1 data
        interior_w = ~first         # directions using X-1 data

        main = rows == Yx[None, :]  # (ny, nx) one-hot rows

        def setD(D, slot, cond_cols, val_cols):
            upd = main & cond_cols[None, :]
            return D.at[slot].set(jnp.where(upd, val_cols[None, :], D[slot]))

        if bottom:
            # D[0] E (:302,:315), D[1] N (:303,:316), D[2] W (:317),
            # D[4] NE (:304,:318), D[5] NW (:319)
            D = setD(D, 0, interior_e & fluid_at(1, Yx),
                     _find_delta(0.0, slope_e, dist))
            D = setD(D, 1, jnp.ones_like(first),
                     1.0 - (yr - Yx.astype(dt)))
            D = setD(D, 2, interior_w & fluid_at(-1, Yx),
                     _find_delta(0.0, slope_w, dist))
            D = setD(D, 4, interior_e & fluid_at(1, Yx + 1),
                     _find_delta(1.0, slope_e, dist))
            D = setD(D, 5, interior_w & fluid_at(-1, Yx + 1),
                     _find_delta(-1.0, slope_w, dist))
        else:
            dist_t = yr - Yx.astype(dt)
            # D[0] E (:346,:360), D[2] W (:361), D[3] S (:348? no: D[3]=1-(Y-yr)
            # :347,:362), D[6] SW (:363), D[7] SE (:348,:364)
            D = setD(D, 0, interior_e & fluid_at(1, Yx),
                     _find_delta(0.0, slope_e, dist_t))
            D = setD(D, 2, interior_w & fluid_at(-1, Yx),
                     _find_delta(0.0, slope_w, dist_t))
            D = setD(D, 3, jnp.ones_like(first),
                     1.0 - (Yx.astype(dt) - yr))
            D = setD(D, 6, interior_w & fluid_at(-1, Yx - 1),
                     _find_delta(1.0, slope_w, dist_t))
            D = setD(D, 7, interior_e & fluid_at(1, Yx - 1),
                     _find_delta(-1.0, slope_e, dist_t))

        # ---- jump nodes between columns X-1 and X (:307-313, :352-358) ----
        Y_prev = jnp.roll(Yx, 1)   # border row of column X-1
        changed = (Yx != Y_prev) & (~first)
        if bottom:
            up = changed & (Yx > Y_prev)     # extra node at (X, Y_prev), D[5]
            dn = changed & (Yx < Y_prev)     # extra node at (X-1, Yx), D[4]
            val_up = _find_delta(-1.0, slope_w, yr - Y_prev.astype(dt))
            val_dn = _find_delta(1.0, slope_w, yr_w - Yx.astype(dt))
            m_up = (rows == Y_prev[None, :]) & up[None, :]
            D = D.at[5].set(jnp.where(m_up, val_up[None, :], D[5]))
            # the down-jump node lives in column X-1: shift markers left so
            # index X-1 carries (dn[X], val_dn[X], row Yx[X])
            dn_l = jnp.roll(dn, -1)
            val_dn_l = jnp.roll(val_dn, -1)
            Yx_l = jnp.roll(Yx, -1)
            m_dn = (rows == Yx_l[None, :]) & dn_l[None, :]
            D = D.at[4].set(jnp.where(m_dn, val_dn_l[None, :], D[4]))
        else:
            up = changed & (Yx > Y_prev)     # extra node at (X-1, Yx), D[7]
            dn = changed & (Yx < Y_prev)     # extra node at (X, Y_prev), D[6]
            val_up = _find_delta(-1.0, slope_w, yr_w - Yx.astype(dt))
            val_dn = _find_delta(1.0, slope_w, yr - Y_prev.astype(dt))
            up_l = jnp.roll(up, -1)
            val_up_l = jnp.roll(val_up, -1)
            Yx_l = jnp.roll(Yx, -1)
            m_up = (rows == Yx_l[None, :]) & up_l[None, :]
            D = D.at[7].set(jnp.where(m_up, val_up_l[None, :], D[7]))
            m_dn = (rows == Y_prev[None, :]) & dn[None, :]
            D = D.at[6].set(jnp.where(m_dn, val_dn[None, :], D[6]))
        return D

    D1 = one_wall(jnp.full((8, ny, nx), 2.0, dtype=dt), yr1, bottom=True)
    D2 = one_wall(jnp.full((8, ny, nx), 2.0, dtype=dt), yr2, bottom=False)
    return D1, D2


# ───────────────────────── collision / BC / streaming ──────────────────────
def collide(state: PulsatileState, p: PulsatileParams):
    """MRT (or BGK) collision on fluid cells (reference MRT_Collision
    :533-541), reading ``g_coll`` (see PulsatileState).  Solid cells of the
    output buffer keep the previous streamed content (``g_stream``) — the
    reference's ping-pong aliasing, which steep staircase walls DO read."""
    geq = pressure_equilibrium(state.P, jnp.stack([state.Ux, state.Uy]),
                               p.rho0, D2Q9)
    # parity mode collides the previous post-collision buffer (the
    # reference's ping-pong aliasing); the physics mode collides what
    # actually streamed in (standard LBM) — see pingpong_quirk
    gin = state.g_coll if p.pingpong else state.g_stream
    if p.collision == "mrt":
        if p.mrt_basis_scrambled:        # reference-verbatim basis
            gout = mrt_collide(gin, geq, np.asarray(p.S))
        else:                            # consistent k-ordered basis
            from ..core.collision import MRT_M_K, MRT_M_K_INV
            gout = mrt_collide(gin, geq, np.asarray(p.S),
                               M=MRT_M_K, Minv=MRT_M_K_INV)
    else:
        gout = bgk_collide(gin, geq, 1.0 / p.tau)
    return jnp.where(state.fluid[None], gout, state.g_stream)


def _shift_xy(a, ex, ey):
    """Value at (Y+ey, X+ex) with wrap (callers mask out-of-domain)."""
    return jnp.roll(a, (-ey, -ex), axis=(0, 1))


def bouzidi(gout, F, deltas, p: PulsatileParams):
    """Quadratic Bouzidi interpolation writing border-cell populations
    (reference Bouzidi_quadratic, :553-601), vectorised over dense Δ fields.

    The reference applies the bottom-wall list fully before the top-wall
    list, and in narrow passages a top-wall link's first sample point is a
    bottom-wall border cell — so the two walls are applied as two sequential
    vectorised passes (within-wall list order has no dependency through the
    F-guarded sample chain in practice)."""
    for delta in deltas:
        gout = _bouzidi_one(gout, F, delta, p)
    return gout


def _bouzidi_one(gout, F, delta, p: PulsatileParams):
    ny, nx = p.ny, p.nx
    X = jnp.arange(nx)[None, :] * jnp.ones((ny, 1), dtype=jnp.int32)
    Y = jnp.arange(ny)[:, None] * jnp.ones((1, nx), dtype=jnp.int32)
    Ffld = F[1:-1, 1:-1]     # F at (Y, X)
    new = gout

    for I in range(1, 9):
        D = delta[I - 1]
        active = D < 1.0
        ex, ey = int(EX_I[I]), int(EY_I[I])
        kI = int(K_FROM_I[I])
        kJ = int(K_FROM_I[JB_I[I]])

        def inDom(m):
            Xm, Ym = X + m * ex, Y + m * ey
            return (Xm >= 0) & (Xm < nx) & (Ym >= 0) & (Ym < ny)

        in1, in2, in3 = inDom(1), inDom(2), inDom(3)
        active = active & in1                          # :572

        # NOTE: stacking (g_J, g_I, F) into one roll per link distance was
        # tried (bitwise-identical) and measured FASTER at 621x64 (+10%)
        # but 1.6x SLOWER at 1261x128 — XLA lowers the stacked (3, ny, nx)
        # roll into an expensive copy at the larger shape.  Per-field
        # shifts are robust across shapes.
        gJ1 = _shift_xy(gout[kJ], ex, ey)
        gJ2 = _shift_xy(gout[kJ], 2 * ex, 2 * ey)
        gJ3 = _shift_xy(gout[kJ], 3 * ex, 3 * ey)
        gI1 = _shift_xy(gout[kI], ex, ey)
        gI2 = _shift_xy(gout[kI], 2 * ex, 2 * ey)
        F1 = _shift_xy(Ffld, ex, ey)
        F2 = _shift_xy(Ffld, 2 * ex, 2 * ey)
        F3 = _shift_xy(Ffld, 3 * ex, 3 * ey)

        # exact reference fallback order (:573-579):
        #   n2 → n1 when OOB; then n2 → n1 when F(n2)<1 (F at post-OOB n2)
        #   n3 → n1 when OOB; then n3 → n2_final when F(n3)<1 (post-OOB n3)
        F2_eff = jnp.where(in2, F2, F1)
        use1for2 = (~in2) | (F2_eff < 1.0)
        gJ2 = jnp.where(use1for2, gJ1, gJ2)
        gI2 = jnp.where(use1for2, gI1, gI2)
        F3_eff = jnp.where(in3, F3, F1)
        gJ3 = jnp.where(in3, gJ3, gJ1)
        gJ3 = jnp.where(F3_eff < 1.0, gJ2, gJ3)

        lt = (gJ1 * (1 + 2 * D) * D
              + gJ2 * (1 - 2 * D) * (1 + 2 * D)
              - gJ3 * (1 - 2 * D) * D)
        ge = (gJ1 - gI1 * (1 - 2 * D) * (1 + 2 * D)
              + gI2 * (1 - 2 * D) * D) / (D * (1 + 2 * D) + 1e-30)
        val = jnp.where(D < 0.5, lt, ge)
        new = new.at[kI].set(jnp.where(active, val, new[kI]))
    return new


def stream_pull(gout):
    """Pull streaming, x periodic (reference Streaming, :603-616; the y wrap
    reads land on permanently solid rows)."""
    out = []
    for k in range(9):
        cx, cy = int(D2Q9.c[k][0]), int(D2Q9.c[k][1])
        out.append(jnp.roll(gout[k], (cy, cx), axis=(0, 1)))
    return jnp.stack(out)


def zou_he(g, yr1, yr2, t, p: PulsatileParams):
    """Zou/He pressure inlet (x=0) and outlet (x=nx−1) in I-space
    (reference :618-669)."""
    dt = g.dtype
    rho0 = p.rho0
    rows = jnp.arange(p.ny)

    kf = [int(K_FROM_I[i]) for i in range(9)]

    # inlet pressure waveform (:619-620)
    tt = jnp.asarray(t, dt)
    Pin = jnp.where(t >= p.t_start,
                    p.pin + p.p_osc * jnp.sin(p.omega * (tt + 1 - p.t_start)),
                    p.pin)
    ylo_i = jnp.maximum(jnp.ceil(yr1[0] - 0.01).astype(jnp.int32), 0)
    yhi_i = jnp.minimum(jnp.floor(yr2[0] + 0.01).astype(jnp.int32), p.ny - 1)
    m_in = (rows >= ylo_i) & (rows <= yhi_i)
    cc = p.corner_closure
    if cc:
        # corner rows get the dedicated closure below, not the bulk form
        m_in_b = m_in & (rows != ylo_i) & (rows != yhi_i)
    else:
        m_in_b = m_in

    col = g[:, :, 0]
    g0, g2, g3 = col[kf[0]], col[kf[2]], col[kf[3]]
    g4, g6, g7 = col[kf[4]], col[kf[6]], col[kf[7]]
    Uin = (Pin - g0 - g2 - 2 * g3 - g4 - 2 * g6 - 2 * g7) * 3.0 / rho0
    new1 = g3 + 2.0 * rho0 / 9.0 * Uin
    new5 = rho0 / 18.0 * Uin - 0.5 * (g2 - g4) + g7
    new8 = rho0 / 18.0 * Uin + 0.5 * (g2 - g4) + g6
    # one column update instead of three (each .at[k,:,0].set copies the
    # whole (9,ny,nx) array; the merged form copies it once)
    newcol = col.at[kf[1]].set(jnp.where(m_in_b, new1, col[kf[1]]))
    newcol = newcol.at[kf[5]].set(jnp.where(m_in_b, new5, col[kf[5]]))
    newcol = newcol.at[kf[8]].set(jnp.where(m_in_b, new8, col[kf[8]]))
    if cc:
        # Zou & He 1997 corner nodes, u = 0, pressure sum closed to Pin.
        # Bottom-left (row ylo, wall below): unknowns E,N,NE,NW,SE;
        # non-eq bounce-back E=W, N=S, NE=SW, buried NW=SE close Σg=Pin.
        # Top-left (row yhi, wall above): unknowns E,S,SE,NE,SW mirrored.
        # Known populations are read PRE-closure (bulk writes above do
        # not touch the corner rows).
        mb = rows == ylo_i
        mt = (rows == yhi_i) & (yhi_i != ylo_i)
        bl_d = 0.5 * (Pin - g0 - 2 * g3 - 2 * g4 - 2 * g7)   # NW = SE
        tl_d = 0.5 * (Pin - g0 - 2 * g2 - 2 * g3 - 2 * g6)   # NE = SW
        newcol = newcol.at[kf[1]].set(
            jnp.where(mb | mt, g3, newcol[kf[1]]))
        newcol = newcol.at[kf[2]].set(jnp.where(mb, g4, newcol[kf[2]]))
        newcol = newcol.at[kf[4]].set(jnp.where(mt, g2, newcol[kf[4]]))
        newcol = newcol.at[kf[5]].set(
            jnp.where(mb, g7, jnp.where(mt, tl_d, newcol[kf[5]])))
        newcol = newcol.at[kf[6]].set(jnp.where(mb, bl_d, newcol[kf[6]]))
        newcol = newcol.at[kf[7]].set(jnp.where(mt, tl_d, newcol[kf[7]]))
        newcol = newcol.at[kf[8]].set(
            jnp.where(mb, bl_d, jnp.where(mt, g6, newcol[kf[8]])))
    g = g.at[:, :, 0].set(newcol)

    # outlet (:644-668)
    Pout = jnp.where(t >= p.t_start + p.t_propagation,
                     p.pout + p.p_osc * jnp.sin(
                         p.omega * (tt + 1 - p.t_start - p.t_propagation)),
                     p.pout)
    if p.is_severed:
        Pout = jnp.where(t > p.t_sever, 0.0, Pout)
    ylo_o = jnp.maximum(jnp.ceil(yr1[-1] - 0.01).astype(jnp.int32), 0)
    yhi_o = jnp.minimum(jnp.floor(yr2[-1] + 0.01).astype(jnp.int32), p.ny - 1)
    m_out = (rows >= ylo_o) & (rows <= yhi_o)
    if cc:
        m_out_b = m_out & (rows != ylo_o) & (rows != yhi_o)
    else:
        m_out_b = m_out

    col = g[:, :, -1]
    g0, g1, g2 = col[kf[0]], col[kf[1]], col[kf[2]]
    g4, g5, g8 = col[kf[4]], col[kf[5]], col[kf[8]]
    Uout = (g0 + 2 * g1 + g2 + g4 + 2 * g5 + 2 * g8 - Pout) * 3.0 / rho0
    new3 = g1 - 2.0 * rho0 / 9.0 * Uout
    new6 = -rho0 / 18.0 * Uout - 0.5 * (g2 - g4) + g8
    new7 = -rho0 / 18.0 * Uout + 0.5 * (g2 - g4) + g5
    newcol = col.at[kf[3]].set(jnp.where(m_out_b, new3, col[kf[3]]))
    newcol = newcol.at[kf[6]].set(jnp.where(m_out_b, new6, col[kf[6]]))
    newcol = newcol.at[kf[7]].set(jnp.where(m_out_b, new7, col[kf[7]]))
    if cc:
        # Bottom-right (wall below): unknowns W,N,NW,NE,SW; W=E, N=S,
        # NW=SE, buried NE=SW close Σg=Pout.  Top-right mirrored.
        mb = rows == ylo_o
        mt = (rows == yhi_o) & (yhi_o != ylo_o)
        br_d = 0.5 * (Pout - g0 - 2 * g1 - 2 * g4 - 2 * g8)  # NE = SW
        tr_d = 0.5 * (Pout - g0 - 2 * g1 - 2 * g2 - 2 * g5)  # NW = SE
        newcol = newcol.at[kf[3]].set(
            jnp.where(mb | mt, g1, newcol[kf[3]]))
        newcol = newcol.at[kf[2]].set(jnp.where(mb, g4, newcol[kf[2]]))
        newcol = newcol.at[kf[4]].set(jnp.where(mt, g2, newcol[kf[4]]))
        newcol = newcol.at[kf[6]].set(
            jnp.where(mb, g8, jnp.where(mt, tr_d, newcol[kf[6]])))
        newcol = newcol.at[kf[5]].set(jnp.where(mb, br_d, newcol[kf[5]]))
        newcol = newcol.at[kf[8]].set(jnp.where(mt, tr_d, newcol[kf[8]]))
        newcol = newcol.at[kf[7]].set(
            jnp.where(mb, br_d, jnp.where(mt, g5, newcol[kf[7]])))
    g = g.at[:, :, -1].set(newcol)
    return g


def macroscopic(g, fluid, p: PulsatileParams):
    """P = Σg, U = 3Σ g c/ρ₀; zeros at solids (reference :216-230).

    Reference quirk reproduced verbatim: the momentum sum runs ``k=1..8`` in
    module ordering (:224), *omitting k=0* (the W direction, c=(−1,0)) — so
    Ux carries a +3·g₀/ρ₀ offset relative to the true first moment."""
    P = jnp.sum(g, axis=0)
    c = np.asarray(D2Q9.c, dtype=np.float64).copy()
    if p.momentum_quirk:
        c[0] = 0.0  # k=0 excluded from the reference's momentum loop
    mom = einsum("kd,kyx->dyx", jnp.asarray(c, dtype=g.dtype), g)
    m = fluid.astype(g.dtype)
    return P * m, 3.0 * mom[0] / p.rho0 * m, 3.0 * mom[1] / p.rho0 * m


# ───────────────────────── wall motion + reseeding ─────────────────────────
def move_walls(P, yr1, yr2, p: PulsatileParams):
    """Per-column wall relaxation toward the pressure-balanced position,
    displacement clamped to ±0.25 (reference :243-272)."""
    Ps1 = P[p.y0, :] - p.p_tissue
    t1 = 0.5 - Ps1 / p.alpha
    d1 = jnp.clip(t1 - yr1, -0.25, 0.25)
    Ps2 = P[p.y0 + 1, :] - p.p_tissue
    t2 = (p.ny - 1 - 0.5) + Ps2 / p.alpha
    d2 = jnp.clip(t2 - yr2, -0.25, 0.25)
    return yr1 + d1, yr2 + d2


def _reseed_simultaneous(g, P, F_old, F_new, fluid_new, p: PulsatileParams):
    """Order-independent fill used only when more fresh cells appear in one
    step than the sequential pass's bound (see reseed_fresh_nodes)."""
    ny, nx = p.ny, p.nx
    dt = g.dtype
    Fo = F_old[1:-1, 1:-1]
    Fn = F_new[1:-1, 1:-1]
    fresh = (Fo < 1.0) & (Fn >= 1.0)

    cols = jnp.arange(nx)[None, :] * jnp.ones((ny, 1), jnp.int32)
    rows = jnp.arange(ny)[:, None] * jnp.ones((1, nx), jnp.int32)
    is_edge = (cols == 0) | (cols == nx - 1)

    # --- inlet/outlet: copy the row toward the channel center (:408-422) ---
    below = rows < p.y0
    g_up = jnp.roll(g, -1, axis=1)    # row Y+1
    g_dn = jnp.roll(g, 1, axis=1)     # row Y-1
    edge_fill = jnp.where(below[None], g_up, g_dn)

    # --- interior: Ffrac-weighted 3x3 average (:465-490) ---
    Ffrac = jnp.trunc(Fo).astype(dt)            # int(Fold) semantics
    Ffrac = jnp.maximum(Ffrac, 0.0)
    neigh_off = [(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
                 (-1, 1), (0, 1), (1, 1)]
    sum_frac = Ffrac  # includes center (0 for fresh cells)
    acc = jnp.zeros_like(g)
    for ox, oy in neigh_off:
        w_nb = _shift_xy(Ffrac, ox, oy)
        sum_frac = sum_frac + w_nb
        acc = acc + jnp.stack([_shift_xy(g[k], ox, oy) for k in range(9)]) * w_nb[None]
    weighted = acc / jnp.maximum(sum_frac, 1e-30)[None]
    # replace only directions whose upstream old cell wasn't plain fluid (:477)
    need = []
    for I in range(9):
        up_frac = _shift_xy(Ffrac, -int(EX_I[I]), -int(EY_I[I]))
        need.append(up_frac != 1.0)
    need_k = jnp.stack([jnp.zeros_like(need[0])] * 9)
    for I in range(9):
        need_k = need_k.at[int(K_FROM_I[I])].set(need[I])
    interior_fill = jnp.where(need_k, weighted, g)

    # --- ring-search fallback when no old-fluid neighbor exists (:424-463) ---
    no_frac = sum_frac <= 0.0
    m_new = fluid_new.astype(dt)
    ring_fill = jnp.zeros_like(g)
    ring_found = jnp.zeros_like(m_new, dtype=bool)
    for R in range(1, 5):
        if R == 1:
            offs = neigh_off
        else:
            offs = [(sx, sy) for sx in range(-R, R + 1)
                    for sy in (R - abs(sx), -(R - abs(sx)))]
            offs = list(dict.fromkeys(offs))
        cnt = jnp.zeros_like(m_new)
        s = jnp.zeros_like(g)
        for ox, oy in offs:
            in_dom = ((cols + ox >= 0) & (cols + ox < nx)
                      & (rows + oy >= 0) & (rows + oy < ny))
            wgt = _shift_xy(m_new, ox, oy) * in_dom.astype(dt)
            cnt = cnt + wgt
            s = s + jnp.stack([_shift_xy(g[k], ox, oy) for k in range(9)]) * wgt[None]
        ok = (cnt > 0) & (~ring_found)
        ring_fill = jnp.where(ok[None], s / jnp.maximum(cnt, 1.0)[None], ring_fill)
        ring_found = ring_found | (cnt > 0)
    geq0 = pressure_equilibrium(P, jnp.zeros((2, ny, nx), dt), p.rho0, D2Q9)
    ring_fill = jnp.where(ring_found[None], ring_fill, geq0)

    interior_fill = jnp.where(no_frac[None], ring_fill, interior_fill)
    fill = jnp.where(is_edge[None], edge_fill, interior_fill)
    return jnp.where((fresh & fluid_new)[None], fill, g)


RESEED_K = 256  # max fresh cells handled exactly per step
_PAD = 4


def reseed_fresh_nodes(g, P, F_old, F_new, fluid_new, p: PulsatileParams):
    """Fill cells that turned from solid to fluid (reference
    Update_Fobj_for_Vessel_Walls + Fill_Fluid_Node, :384-498).

    The reference processes fresh cells *sequentially* in x-then-y order and
    its ring-search fallback reads neighbours filled earlier in the same
    sweep, so the result is order-dependent.  But the order is only
    *observable* when a fresh cell's fill READS another fresh cell: the
    Ffrac-weighted 3×3 average weights neighbours by ``trunc(F_old)``, which
    is 0 for every fresh cell, so it reads old-fluid populations only; only
    the ring-search fallback (fires when the 3×3 has NO old-fluid neighbour)
    and an inlet/outlet copy whose source row is itself fresh can see
    earlier fills.  Wall-motion waves seed O(100) cells in one step
    (measured: 159 at step 51 of the reference config), so the common case
    is made fast: a *batched* pass computes every fill from the pre-reseed
    state with the same per-cell expression tree as the sequential loop
    (equal to within compiler FMA/fusion reassociation, ≤1 ulp, when no
    fill reads a fresh cell), and a ``lax.cond`` falls back to the exact
    sequential ``fori_loop`` on the rare order-dependent steps.  Steps with
    NO fresh cells (the majority) skip the whole dispatch behind an outer
    cond and pay only the fresh-mask reduction.
    """
    Fo = F_old[1:-1, 1:-1]
    Fn = F_new[1:-1, 1:-1]
    fresh = (Fo < 1.0) & (Fn >= 1.0) & fluid_new
    n_fresh = jnp.sum(fresh.astype(jnp.int32))

    def _do(gg):
        return _reseed_dispatch(gg, P, F_old, F_new, fluid_new, fresh,
                                n_fresh, p)

    return jax.lax.cond(n_fresh > 0, _do, lambda gg: gg, g)


def _reseed_dispatch(g, P, F_old, F_new, fluid_new, fresh, n_fresh,
                     p: PulsatileParams):
    ny, nx = p.ny, p.nx
    dt = g.dtype
    Fo = F_old[1:-1, 1:-1]

    # x-major ordering of fresh cells (reference loop :389)
    fresh_T = jnp.transpose(fresh).reshape(-1)          # index = x*ny + y
    idxs = jnp.nonzero(fresh_T, size=RESEED_K, fill_value=-1)[0]

    Ffrac = jnp.maximum(jnp.trunc(Fo), 0.0).astype(dt)  # int(Fold) weights
    pad2 = ((_PAD, _PAD), (_PAD, _PAD))
    Ffrac_p = jnp.pad(Ffrac, pad2)
    fluid_p = jnp.pad(fluid_new, pad2).astype(dt)
    fresh_p = jnp.pad(fresh, pad2)
    gp = jnp.pad(g, ((0, 0),) + pad2)

    y0c = p.y0

    def fill_val(gsrc, idx):
        """One cell's fill value from the populations in ``gsrc`` — the
        shared arithmetic of the sequential and batched paths (bitwise
        identical by construction).  Also returns whether this fill READS
        potentially-fresh cells (ring fallback / fresh edge source), i.e.
        whether processing order is observable for it."""
        x = idx // ny
        y = idx % ny
        yy, xx = y + _PAD, x + _PAD

        win = jax.lax.dynamic_slice(gsrc, (0, yy - 4, xx - 4), (9, 9, 9))
        fw = jax.lax.dynamic_slice(fluid_p, (yy - 4, xx - 4), (9, 9))
        Fw = jax.lax.dynamic_slice(Ffrac_p, (yy - 4, xx - 4), (9, 9))
        fr = jax.lax.dynamic_slice(fresh_p, (yy - 4, xx - 4), (9, 9))

        # --- inlet/outlet: copy the row toward the channel center (:408-422)
        edge_val = jnp.where(y < y0c, win[:, 5, 4], win[:, 3, 4])
        edge_src_fresh = jnp.where(y < y0c, fr[5, 4], fr[3, 4])

        # --- Ffrac-weighted 3x3 average (:465-490) ---
        # explicit fixed-order accumulation (not einsum/sum): the batched
        # vmap path must execute the SAME expression tree as the sequential
        # loop so the two are bitwise identical, and reduction primitives
        # lower with different accumulation orders under vmap
        W3 = Fw[3:6, 3:6]
        sum_frac = jnp.zeros((), dt)
        acc = jnp.zeros((9,), dt)
        for j in range(3):
            for i in range(3):
                sum_frac = sum_frac + W3[j, i]
                acc = acc + win[:, 3 + j, 3 + i] * W3[j, i]  # center weight 0
        weighted = acc / jnp.maximum(sum_frac, 1e-30)
        cur = win[:, 4, 4]
        int_val = cur
        for I in range(9):
            exi, eyi = int(EX_I[I]), int(EY_I[I])
            kI = int(K_FROM_I[I])
            need = W3[1 - eyi, 1 - exi] != 1.0
            int_val = int_val.at[kI].set(jnp.where(need, weighted[kI], cur[kI]))

        # --- ring search on new-fluid cells (:425-463) ---
        ring_val = jnp.zeros((9,), dt)
        found = jnp.asarray(False)
        for R in range(1, 5):
            if R == 1:
                offs = [(1, 0), (-1, 0), (0, 1), (0, -1),
                        (1, 1), (1, -1), (-1, 1), (-1, -1)]
            else:
                offs = [(sx, sy) for sx in range(-R, R + 1)
                        for sy in (R - abs(sx), -(R - abs(sx)))]
                offs = list(dict.fromkeys(offs))
            cnt = jnp.asarray(0.0, dt)
            s = jnp.zeros((9,), dt)
            for ox, oy in offs:
                wgt = fw[4 + oy, 4 + ox]
                cnt = cnt + wgt
                s = s + win[:, 4 + oy, 4 + ox] * wgt
            ok = (cnt > 0) & (~found)
            ring_val = jnp.where(ok, s / jnp.maximum(cnt, 1.0), ring_val)
            found = found | (cnt > 0)
        # fallback: equilibrium at (P=0, u=0) ≡ zeros (:459-462)
        ring_val = jnp.where(found, ring_val, jnp.zeros((9,), dt))

        is_edge = (x == 0) | (x == nx - 1)
        val = jnp.where(is_edge, edge_val,
                        jnp.where(sum_frac == 0.0, ring_val, int_val))
        order_dep = jnp.where(is_edge, edge_src_fresh,
                              sum_frac == 0.0)   # ring reads fluid_new cells
        return val, order_dep, yy, xx

    def fill_one(i, gp):
        idx = idxs[i]
        val, _, yy, xx = fill_val(gp, idx)
        upd = jax.lax.dynamic_update_slice(gp, val.reshape(9, 1, 1),
                                           (0, yy, xx))
        return jnp.where(idx >= 0, upd, gp)

    # ---- dense batched pass ----
    # Every fill from the PRE-reseed state via 9 stacked rolls over the
    # whole lattice — the same (j, i) accumulation order as fill_val's
    # window loop, so it matches the sequential pass to FMA reassociation.
    # The ring fallback is NOT computed here: a cell that needs it is
    # order-dependent by definition and routes the whole step to the exact
    # sequential loop below.
    stack = jnp.concatenate(
        [g, Ffrac[None], fresh[None].astype(dt)], axis=0)   # (11, ny, nx)
    sum_frac_d = jnp.zeros((ny, nx), dt)
    acc_d = jnp.zeros((9, ny, nx), dt)
    rolled = {}
    for j in range(3):
        for i in range(3):
            ex, ey = i - 1, j - 1
            # value at (Y+ey, X+ex) on the trailing two axes.  The
            # sequential oracle (fill_val) reads ZERO-padded windows, so
            # the rows/cols that wrapped around must be zeroed to match —
            # otherwise a fresh cell at y=0/ny-1 would see wrapped
            # neighbor weights (advisor round 2).
            nb = stack if ex == 0 and ey == 0 else jnp.roll(
                stack, (-ey, -ex), axis=(1, 2))
            if ey != 0:
                nb = nb.at[:, ny - 1 if ey > 0 else 0, :].set(0.0)
            if ex != 0:
                nb = nb.at[:, :, nx - 1 if ex > 0 else 0].set(0.0)
            rolled[(ex, ey)] = nb
            Fnb = nb[9]
            sum_frac_d = sum_frac_d + Fnb
            acc_d = acc_d + nb[:9] * Fnb[None]
    weighted_d = acc_d / jnp.maximum(sum_frac_d, 1e-30)[None]
    by_k = [None] * 9
    for I in range(9):
        exi, eyi = int(EX_I[I]), int(EY_I[I])
        kI = int(K_FROM_I[I])
        need = rolled[(-exi, -eyi)][9] != 1.0   # upstream Ffrac (W3 index)
        by_k[kI] = jnp.where(need, weighted_d[kI], g[kI])
    int_val_d = jnp.stack(by_k)
    rows_d = jnp.arange(ny)[:, None]
    cols_d = jnp.arange(nx)[None, :]
    is_edge_d = (cols_d == 0) | (cols_d == nx - 1)
    below_d = rows_d < y0c
    edge_val_d = jnp.where(below_d[None], rolled[(0, 1)][:9],
                           rolled[(0, -1)][:9])
    edge_src_fresh_d = jnp.where(below_d, rolled[(0, 1)][10],
                                 rolled[(0, -1)][10]) > 0.5
    val_d = jnp.where(is_edge_d[None], edge_val_d, int_val_d)
    dep_map = fresh & jnp.where(is_edge_d, edge_src_fresh_d,
                                sum_frac_d == 0.0)
    any_dep = jnp.any(dep_map)

    def seq_path(_):
        # trip count = actual fresh cells (idxs beyond n_fresh are -1 fills
        # the old fixed-bound loop discarded anyway; skipping is bit-exact)
        gp_s = jax.lax.fori_loop(0, jnp.minimum(n_fresh, RESEED_K),
                                 fill_one, gp)
        return gp_s[:, _PAD:-_PAD, _PAD:-_PAD]

    def batch_path(_):
        return jnp.where(fresh[None], val_d, g)

    g_seq = jax.lax.cond(any_dep, seq_path, batch_path, 0)

    # overflow cells (beyond RESEED_K) → simultaneous fill; only reachable
    # through the sequential branch (the dense batch pass covers ALL fresh
    # cells); guarded by a cond so it costs nothing per step
    def with_overflow(g_seq):
        order = jnp.cumsum(fresh_T.astype(jnp.int32))
        over = (fresh_T & (order > RESEED_K)).reshape(nx, ny).T
        g_sim = _reseed_simultaneous(g, P, F_old, F_new, fluid_new, p)
        return jnp.where(over[None], g_sim, g_seq)

    return jax.lax.cond(any_dep & (n_fresh > RESEED_K), with_overflow,
                        lambda gs: gs, g_seq)


# ───────────────────────── full step ───────────────────────────────────────
def step(state: PulsatileState, t, p: PulsatileParams):
    """One iteration in the reference driver order (:764-791):
    collide → Bouzidi → pull stream → Zou/He → macro → wall move/rebuild."""
    delta = border_deltas(state.F, state.yr1, state.yr2, p)
    gout = collide(state, p)
    gout = bouzidi(gout, state.F, delta, p)
    g = stream_pull(gout)
    g = zou_he(g, state.yr1, state.yr2, t, p)
    P, Ux, Uy = macroscopic(g, state.fluid, p)
    return finish_step(state, gout, g, P, Ux, Uy, p)


def finish_step(state: PulsatileState, gout, g, P, Ux, Uy,
                p: PulsatileParams):
    """Geometry tail of the step (wall ODE → Fobj → reseeding → macro
    fixups)."""
    if p.deformable:
        yr1, yr2 = move_walls(P, state.yr1, state.yr2, p)
        F_new = fobj_from_walls(yr1, yr2, p)
        fluid_new = flags_from_fobj(F_new, p)
        # killed cells keep their streamed populations (reference never
        # zeroes them; they feed the solid-cell aliasing in `collide`)
        g = reseed_fresh_nodes(g, P, state.F, F_new, fluid_new, p)
        P_pre, Ux_pre, Uy_pre = P, Ux, Uy
        P, Ux, Uy = macroscopic(g, fluid_new, p)
        # killed cells keep their last fluid macro values until the NEXT
        # step's sweep zeroes them (reference zeroes solids in
        # Macroscopic_Properties_g which runs before the wall move)
        killed = state.fluid & (~fluid_new)
        P = jnp.where(killed, P_pre, P)
        Ux = jnp.where(killed, Ux_pre, Ux)
        Uy = jnp.where(killed, Uy_pre, Uy)
        # fresh cells get the FULL first moment (reference
        # Fresh_Macroscopic_Values :492-498 sums I=1..8, i.e. all moving k),
        # unlike the k=0-skipping regular sweep
        fresh = (state.F[1:-1, 1:-1] < 1.0) & (F_new[1:-1, 1:-1] >= 1.0) & fluid_new
        c_full = jnp.asarray(D2Q9.c, dtype=g.dtype)
        mom = einsum("kd,kyx->dyx", c_full, g)
        Ux = jnp.where(fresh, 3.0 * mom[0] / p.rho0, Ux)
        Uy = jnp.where(fresh, 3.0 * mom[1] / p.rho0, Uy)
        return PulsatileState(gout, g, yr1, yr2, P, Ux, Uy, F_new, fluid_new)
    return PulsatileState(gout, g, state.yr1, state.yr2, P, Ux, Uy,
                          state.F, state.fluid)


@partial(jax.jit, static_argnames=("p", "n_steps"))
def run(state: PulsatileState, t0, p: PulsatileParams, n_steps: int):
    def body(carry, i):
        return step(carry, t0 + i, p), None
    state, _ = jax.lax.scan(body, state, jnp.arange(n_steps))
    return state


# ───────────────────────── initialization ──────────────────────────────────
def initialize(p: PulsatileParams, dtype=jnp.float64) -> PulsatileState:
    """Theoretical tapered-vessel geometry + parabolic flow init
    (reference :174-213, driver :753-757)."""
    nx, ny = p.nx, p.ny
    yc = p.yc
    a = p.alpha

    yr1_in = yc - (p.pin - p.p_tissue) / a
    yr2_in = yc + (p.pin - p.p_tissue) / a
    yr1_out = yc - (p.pout - p.p_tissue) / a
    yr2_out = yc + (p.pout - p.p_tissue) / a
    if yr1_in < 1 or yr2_in > ny - 2 or yr1_out < 1 or yr2_out > ny - 2:
        raise RuntimeError("Initial wall location out of bounds.")
    R0 = (yr2_in - yr1_in) / 2.0
    RL = (yr2_out - yr1_out) / 2.0
    X = np.arange(nx, dtype=np.float64)
    Rx = ((RL ** 4 - R0 ** 4) * (X / (nx - 1)) + R0 ** 4) ** 0.25
    yr1 = yc - Rx
    yr2 = yc + Rx
    P = np.broadcast_to((yr2 - (ny - 1 - 0.5)) * a + p.p_tissue, (ny, nx)).copy()

    F = np.asarray(fobj_from_walls(jnp.asarray(yr1), jnp.asarray(yr2), p))
    fluid = F[1:-1, 1:-1] >= 1.0

    # parabolic Ux from local dP/dx (:191-204)
    mu = p.rho0 * (p.tau - 0.5) / 3.0
    dpx = np.gradient(P, axis=1)
    dpx[:, 0] = P[:, 1] - P[:, 0]
    dpx[:, -1] = P[:, -1] - P[:, -2]
    Y = np.arange(ny, dtype=np.float64)[:, None]
    inside = (Y >= np.ceil(yr1 - 0.01)[None, :]) & (Y <= np.floor(yr2 + 0.01)[None, :])
    Ux = np.where(inside, dpx / (2 * mu) * (Y - yr1[None, :]) * (Y - yr2[None, :]), 0.0)
    Uy = np.zeros_like(Ux)

    g = np.asarray(pressure_equilibrium(
        jnp.asarray(P, dtype), jnp.asarray(np.stack([Ux, Uy]), dtype),
        p.rho0, D2Q9))
    g = g * fluid[None]
    ga = jnp.asarray(g, dtype)
    return PulsatileState(
        g_coll=ga,
        # also the first collision input in the physics mode
        # (pingpong=False); bit-identical for parity mode — g is zeroed
        # at solids above, and fluid-cell g_stream is unread there
        g_stream=ga,
        yr1=jnp.asarray(yr1, dtype), yr2=jnp.asarray(yr2, dtype),
        P=jnp.asarray(P * fluid, dtype),
        Ux=jnp.asarray(Ux * fluid, dtype), Uy=jnp.asarray(Uy * fluid, dtype),
        F=jnp.asarray(F, dtype), fluid=jnp.asarray(fluid))


def initialize_rigid_channel(p: PulsatileParams, yr_bottom: float,
                             yr_top: float,
                             dtype=jnp.float64) -> PulsatileState:
    """Straight rigid channel at fractional wall positions with a linear
    inlet→outlet pressure ramp — the quirk-OFF physics-validation
    geometry (validation/womersley.py module gate).

    The REFERENCE cannot construct this: its geometry initializer pins
    the inlet radius to 0 via ``p_tissue = p0_in``
    (PulsatileBloodFlow2D.h:156-158), so a plain open channel through the
    full Zou/He + Bouzidi machinery was never exercised upstream.  Use
    with ``deformable=False`` (the walls then stay at the given
    positions)."""
    nx, ny = p.nx, p.ny
    yr1 = jnp.full((nx,), yr_bottom, dtype)
    yr2 = jnp.full((nx,), yr_top, dtype)
    F = fobj_from_walls(yr1, yr2, p)
    fluid = flags_from_fobj(F, p)
    P = jnp.broadcast_to(jnp.linspace(p.pin, p.pout, nx, dtype=dtype),
                         (ny, nx)) * fluid
    U0 = jnp.zeros((ny, nx), dtype)
    g = pressure_equilibrium(P, jnp.stack([U0, U0]), p.rho0, D2Q9) \
        * fluid[None]
    return PulsatileState(g_coll=g, g_stream=g, yr1=yr1, yr2=yr2,
                          P=P, Ux=U0, Uy=U0, F=F, fluid=fluid)
