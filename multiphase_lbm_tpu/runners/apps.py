"""Per-problem drivers, schema-compatible with the reference app modules.

Each driver reads the reference's ``config_*.txt`` keys, runs the solver in
chunks of the output cadence (one compiled ``lax.scan`` per chunk), and
emits the same observables: ``sol_*.vtk`` with the module's exact field list,
``energy.dat`` / ``mass.dat`` / ``contact_angle.dat`` /
``spike_bubble_position.dat`` logs, and the final MLUPS line.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..io.config import lb_parameters, load_config, omega_from_tau
from ..models import combustion as cb
from ..models import fakhari as fk
from ..models import hcz
from ..models import pulsatile as pb
from ..models import shan_chen as sc
from ..models import shan_chen_rt as rt
from .common import Driver, next_chunk


def _num(cfg, key, default):
    return float(cfg.get(key, default))


def _int(cfg, key, default):
    return int(float(cfg.get(key, default)))


def _omega(cfg, N):
    """tau override wins over (Re, ulb) (reference laplace2D.h:441-449)."""
    tau = float(cfg.get("tau", -1.0))
    if tau > 0:
        nu, omega = omega_from_tau(tau)
        dx = 1.0 / N
        dt = dx * _num(cfg, "ulb", 0.1)
    else:
        nu, omega, dx, dt = lb_parameters(_num(cfg, "ulb", 0.1), N,
                                          _num(cfg, "Re", 60.0))
    return omega, dx, dt


# ─── Shan-Chen Laplace droplet (reference laplace2D.h driver :405-512) ─────
def run_sc_laplace2d(config, outdir, dtype=jnp.float64, max_steps=None):
    cfg = load_config(config)
    N = _int(cfg, "N", 100)
    omega, dx, dt = _omega(cfg, N)
    p = sc.SCParams(
        omega=omega, a=_num(cfg, "a", 1.0), b=_num(cfg, "b", 4.0),
        R=_num(cfg, "R", 1.0), TT0=_num(cfg, "TT0", 0.875),
        rhol=_num(cfg, "rhol", 1.0), rhog=_num(cfg, "rhog", 0.1),
        rho_w=_num(cfg, "rho_w", 0.12), gravity=_num(cfg, "gravity", 0.0))
    # reference laplace2D.h:137 hardcodes Rdrop=10; honor an RR config key
    # when present (the contactAngle2D family reads it) with that default
    f = sc.init_droplet(N, N, p, radius=_num(cfg, "RR", 10.0), dtype=dtype)
    fluid = sc.geometry_periodic(N, N)
    steps = max_steps or int(_num(cfg, "max_t", 10.0) / dt)
    return _run_sc(p, f, fluid, steps, cfg, outdir, dx, dt, contact=False)


# ─── Shan-Chen contact angle (reference contactAngle2D.h :644-807) ─────────
def run_sc_contact_angle(config, outdir, dtype=jnp.float64, max_steps=None):
    cfg = load_config(config)
    N = _int(cfg, "N", 200)
    omega, dx, dt = _omega(cfg, N)
    p = sc.SCParams(
        omega=omega, a=_num(cfg, "a", 1.0), b=_num(cfg, "b", 4.0),
        R=_num(cfg, "R", 1.0), TT0=_num(cfg, "TT0", 0.875),
        rhol=_num(cfg, "rhol", 0.265), rhog=_num(cfg, "rhog", 0.038),
        rho_w=_num(cfg, "rhow", _num(cfg, "rho_w", 0.2)),
        gravity=_num(cfg, "gravity", 0.0))
    nx, ny = 2 * N, N
    RR = _num(cfg, "RR", 100.0)
    f = sc.init_droplet(nx, ny, p, radius=RR, center=(nx // 2, 5.0), dtype=dtype)
    fluid = sc.geometry_channel_walls(nx, ny)
    f = sc.apply_geometry(f, fluid)
    steps = max_steps or int(_num(cfg, "max_t", 50.0) / dt)
    return _run_sc(p, f, fluid, steps, cfg, outdir, dx, dt, contact=True)


# ─── Shan-Chen layered flow (reference SC twoLayeredFlow2D.h :457-598) ─────
def run_sc_two_layered(config, outdir, dtype=jnp.float64, max_steps=None):
    cfg = load_config(config)
    N = _int(cfg, "N", 100)
    omega, dx, dt = _omega(cfg, N)
    p0 = sc.SCParams(
        omega=omega, a=_num(cfg, "a", 1.0), b=_num(cfg, "b", 4.0),
        R=_num(cfg, "R", 1.0), TT0=_num(cfg, "TT0", 0.95),
        rhol=_num(cfg, "rhol", 0.21), rhog=_num(cfg, "rhog", 0.067),
        rho_w=_num(cfg, "rho_w", 0.067), psi_mode="const_g",
        G=_num(cfg, "G", -1.0), gx_u=_num(cfg, "gx", 1e-8),
        gy_u=_num(cfg, "gy", 0.0))
    p = dataclasses.replace(p0, p_shift=sc.compute_p_shift(p0))
    f = sc.init_layers(N, N, p, h_lower=_num(cfg, "h_lower", 0.3),
                       w_int=_int(cfg, "w_int", 4), dtype=dtype)
    fluid = sc.geometry_channel_walls(N, N)
    f = sc.apply_geometry(f, fluid)
    steps = max_steps or int(_num(cfg, "max_t", 200.0) / dt)
    return _run_sc(p, f, fluid, steps, cfg, outdir, dx, dt, contact=False)


def _run_sc(p, f, fluid, steps, cfg, outdir, dx, dt, contact):
    ny, nx = fluid.shape
    drv = Driver(outdir, nx * ny, out_freq=_int(cfg, "out_freq", 400),
                 vtk_freq=_int(cfg, "vtk_freq", 400))
    m0 = None
    it = 0
    while it < steps:
        if drv.want_vtk(it):
            # fields stay ON DEVICE: the async dump worker pulls them,
            # so the time loop never blocks on the host transfer
            rho = sc.density(f)
            pr = sc.node_pressure(f, p)
            F = sc.sc_force(rho, fluid, p)
            flm = fluid.astype(rho.dtype)
            drv.write_vtk(it, nx, ny, spacing=dx,
                          scalars=[("Density", rho * flm),
                                   ("Pressure", pr * flm)],
                          vectors=[("Force", F)])
        if drv.want_out(it):
            e = float(sc.kinetic_energy(f, fluid, p)) * dx * dx / (dt * dt)
            m = float(sc.total_mass(f, fluid))
            if m0 is None:
                m0 = m
            drv.log_file("energy.dat").log(it * dt, e)
            drv.log_file("mass.dat").log(it * dt, m)
            if contact:
                res = sc.contact_angle(np.asarray(sc.density(f)),
                                       np.asarray(fluid), p.rhol, p.rhog)
                if res:
                    drv.log_file("contact_angle.dat").log(*res)
        chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
        f = sc.run(f, fluid, p, chunk)
        drv.clock.tick(chunk)
        it += chunk
    drv.finish()
    return f


# ─── Fakhari Young-Laplace (reference Young_Laplace2D.h :456-568) ──────────
def run_young_laplace2d(config, outdir, dtype=jnp.float64, max_steps=None):
    cfg = load_config(config)
    N = _int(cfg, "N", 128)
    p = fk.FakhariParams(
        sigma=_num(cfg, "Sigma", 0.01), W=_num(cfg, "W", 4.0),
        M=_num(cfg, "M", 0.02), rhol=_num(cfg, "RhoL", 0.001),
        rhoh=_num(cfg, "RhoH", 1.0), tau=_num(cfg, "tau", 0.8))
    state = fk.init_bubble(N, N, p, dtype=dtype)
    steps = max_steps or _int(cfg, "tf", 10000)
    drv = Driver(outdir, N * N, out_freq=_int(cfg, "out_freq", 1000),
                 vtk_freq=_int(cfg, "vtk_freq", 1000))
    m0 = None
    it = 0
    while it <= steps:
        if drv.want_vtk(it):
            C = fk.phase_field(state)
            P = fk.pressure(state)
            u = state[2]
            drv.write_vtk(it, N, N,
                          scalars=[("phi", C), ("Pressure", P)],
                          vectors=[("velocity", u)],
                          int_scalars=[("Flag", np.zeros((N, N), int))])
        if drv.want_out(it):
            e = float(fk.kinetic_energy(state))
            m = float(fk.total_mass(state, p))
            if m0 is None:
                m0 = m
            drv.log_file("energy.dat").log(it, e)
            drv.log_file("mass.dat").log(it, m)
        chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
        state = fk.run(state, p, chunk)
        drv.clock.tick(chunk)
        it += chunk
    drv.finish()
    return state


# ─── HCZ Rayleigh-Taylor (reference PF rayleighTaylor2D.h :862-988) ────────
def run_rayleigh_taylor_pf(config, outdir, dtype=jnp.float64, max_steps=None):
    cfg = load_config(config)
    N = _int(cfg, "N", 256)
    nu, omega, dx, dt = lb_parameters(_num(cfg, "ulb", 0.04), N,
                                      _num(cfg, "Re", 3000.0))
    p = hcz.HCZParams(
        omega=omega, phi_l=_num(cfg, "phi_l", 0.251),
        phi_g=_num(cfg, "phi_g", 0.024), rho_l=_num(cfg, "rho_l", 0.12),
        rho_g=_num(cfg, "rho_g", 0.04), a=_num(cfg, "a", 4.0),
        b=_num(cfg, "b", 4.0), kappa=_num(cfg, "kappa", 0.01),
        gravity=_num(cfg, "gravity", -6.25e-6))
    ny = 4 * N + 2
    state = hcz.init_rayleigh_taylor(N, ny, p, dtype=dtype)
    fluid = hcz.geometry_channel(N, ny)
    state = hcz.apply_geometry(state, fluid)
    steps = max_steps or int(_num(cfg, "max_t", 5.01) / dt)
    drv = Driver(outdir, N * ny, out_freq=_int(cfg, "out_freq", 3200),
                 vtk_freq=_int(cfg, "vtk_freq", 3200))
    it = 0
    prev_sb = None
    while it < steps:
        if drv.want_vtk(it):
            phi = hcz.order_parameter(state[0])
            rho = hcz.rho_of_phi(phi, p)
            flg = (~np.asarray(fluid)).astype(int)   # static, tiny
            drv.write_vtk(it, N, ny, spacing=1.0 / N,
                          scalars=[("phi", phi), ("density", rho)],
                          int_scalars=[("Flag", flg)])
        if drv.want_out(it):
            e = float(hcz.kinetic_energy(state, fluid, p)) * dx * dx / (dt * dt)
            drv.log_file("energy.dat").log(it * dt, e)
            s, b = hcz.interface_heights(
                np.asarray(hcz.order_parameter(state[0])), p)
            drv.log_file("spike_bubble_position.dat").log(
                it * dt, s * dx, b * dx)
            # finite-difference interface velocities over the output
            # cadence — the series the reference's validation notebook
            # derives from the positions (rayleighTaylor2D.h:939 opens the
            # file; Untitled.py cells 2-4 compute and smooth d(pos)/dt)
            if prev_sb is not None:
                t_prev, s_prev, b_prev = prev_sb
                dti = it * dt - t_prev
                drv.log_file("spike_bubble_velocity.dat").log(
                    it * dt, (s * dx - s_prev) / dti,
                    (b * dx - b_prev) / dti)
            prev_sb = (it * dt, s * dx, b * dx)
        chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
        state = hcz.run(state, fluid, p, chunk)
        drv.clock.tick(chunk)
        it += chunk
    drv.finish()
    return state


# ─── HCZ layered channel (reference PF twoLayeredFlow2D.h :762-905) ────────
def run_two_layered_pf(config, outdir, dtype=jnp.float64, max_steps=None):
    cfg = load_config(config)
    N = _int(cfg, "N", 100)
    omega, dx, dt = _omega(cfg, N)
    p = hcz.HCZParams(
        omega=omega, phi_l=_num(cfg, "phi_l", 0.251),
        phi_g=_num(cfg, "phi_g", 0.024), rho_l=_num(cfg, "rho_l", 0.12),
        rho_g=_num(cfg, "rho_g", 0.04), a=_num(cfg, "a", 4.0),
        b=_num(cfg, "b", 4.0), kappa=_num(cfg, "kappa", 0.001),
        gx=_num(cfg, "gx", 0.0), Gx_const=_num(cfg, "Gx_const", 1e-8))
    state = hcz.init_layers(N, N, p, h_lower=_num(cfg, "h_lower", 0.3),
                            w_int=_int(cfg, "w_int", 2), dtype=dtype)
    fluid = hcz.geometry_channel(N, N)
    state = hcz.apply_geometry(state, fluid)
    steps = max_steps or int(_num(cfg, "max_t", 50.0) / dt)
    drv = Driver(outdir, N * N, out_freq=_int(cfg, "out_freq", 500),
                 vtk_freq=_int(cfg, "vtk_freq", 1000))
    it = 0
    while it < steps:
        if drv.want_vtk(it):
            phi = hcz.order_parameter(state[0])
            rho = hcz.rho_of_phi(phi, p)
            drv.write_vtk(it, N, N, spacing=dx,
                          scalars=[("phi", phi), ("density", rho)],
                          int_scalars=[("Flag", (~np.asarray(fluid)).astype(int))])
        if drv.want_out(it):
            e = float(hcz.kinetic_energy(state, fluid, p)) * dx * dx / (dt * dt)
            drv.log_file("energy.dat").log(it * dt, e)
            rho = np.asarray(hcz.rho_of_phi(hcz.order_parameter(state[0]), p))
            drv.log_file("density_probe.dat").log(
                it * dt, float(rho[N // 2, N // 2]), float(rho[2, N // 2]))
        chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
        state = hcz.run(state, fluid, p, chunk)
        drv.clock.tick(chunk)
        it += chunk
    drv.finish()
    return state


# ─── HCZ 3D droplet (reference laplace3D.h :853-952) ───────────────────────
def run_laplace3d(config, outdir, dtype=jnp.float64, max_steps=None):
    cfg = load_config(config)
    N = _int(cfg, "N", 100)
    nu, omega, dx, dt = lb_parameters(_num(cfg, "ulb", 0.01), N,
                                      _num(cfg, "Re", 6.0))
    p = hcz.HCZParams(
        omega=omega, phi_l=_num(cfg, "phi_l", 0.251),
        phi_g=_num(cfg, "phi_g", 0.024), rho_l=_num(cfg, "rho_l", 0.12),
        rho_g=_num(cfg, "rho_g", 0.04), a=_num(cfg, "a", 4.0),
        b=_num(cfg, "b", 4.0), kappa=_num(cfg, "kappa", 5e-4),
        gravity=_num(cfg, "gravity", 0.0))
    state = hcz.init_droplet_3d(N, N, N, p, dtype=dtype)
    fluid = hcz.geometry_periodic_3d(N, N, N)
    steps = max_steps or int(_num(cfg, "max_t", 5.0) / dt)
    drv = Driver(outdir, N ** 3, out_freq=_int(cfg, "out_freq", 100),
                 vtk_freq=_int(cfg, "vtk_freq", 100))
    it = 0
    while it < steps:
        if drv.want_vtk(it):
            phi = hcz.order_parameter(state[0])
            drv.write_vtk(it, N, N, N, spacing=1.0 / N,
                          scalars=[("phi", phi)])
        if drv.want_out(it):
            e = float(hcz.kinetic_energy(state, fluid, p, hcz.D3Q19,
                                         three_d=True))
            drv.log_file("energy.dat").log(it * dt, e)
        chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
        state = hcz.run(state, fluid, p, chunk, lattice=hcz.D3Q19,
                        three_d=True)
        drv.clock.tick(chunk)
        it += chunk
    drv.finish()
    return state


# ─── SC Rayleigh-Taylor (reference SC RayleighTaylor2D.h :578-670) ─────────
def run_rayleigh_taylor_sc(config, outdir, dtype=jnp.float64, max_steps=None):
    cfg = load_config(config)
    N = _int(cfg, "N", 128)
    nu, omega, dx, dt = lb_parameters(_num(cfg, "ulb", 0.04), N,
                                      _num(cfg, "Re", 30.72))
    p = rt.SCRTParams(
        omega=omega, rhol=_num(cfg, "rhol", 1.2), rhog=_num(cfg, "rhog", 0.4),
        g=_num(cfg, "g", -5.0), gravity=_num(cfg, "gravity", -1.25e-5))
    nx, ny = N, 4 * N + 2     # reference dim {N, 4N+2} (RayleighTaylor2D.h:622)
    f = rt.init_interface(nx, ny, p, dtype=dtype)
    fluid = rt.geometry_channel(nx, ny)
    f = f * fluid[None].astype(f.dtype)
    steps = max_steps or int(_num(cfg, "max_t", 50.01) / dt)
    drv = Driver(outdir, nx * ny, out_freq=_int(cfg, "out_freq", 100),
                 vtk_freq=_int(cfg, "vtk_freq", 100))
    it = 0
    while it < steps:
        if drv.want_vtk(it):
            rho = rt.density(f)
            drv.write_vtk(it, nx, ny, spacing=dx,
                          scalars=[("Density", rho)],
                          int_scalars=[("Flag", (~np.asarray(fluid)).astype(int))])
        if drv.want_out(it):
            e = float(rt.kinetic_energy(f, fluid, p)) * dx * dx / (dt * dt)
            drv.log_file("energy.dat").log(it * dt, e)
            drv.log_file("mass.dat").log(it * dt,
                                         float(jnp.sum(rt.density(f) * fluid)))
            s, bub = rt.interface_height(np.asarray(rt.density(f)),
                                         np.asarray(fluid), p)
            drv.log_file("spike_bubble_position.dat").log(
                it * dt, s * dx, bub * dx)
        chunk = next_chunk(it, steps, drv.out_freq, drv.vtk_freq)
        f = rt.run(f, fluid, p, chunk)
        drv.clock.tick(chunk)
        it += chunk
    drv.finish()
    return f


# ─── Pulsatile vessel (reference PulsatileBloodFlow2D.h :719-794) ──────────
def run_pulsatile(outdir, N=64, dtype=jnp.float64, max_steps=None,
                  async_io=True, momentum_quirk=True):
    p = pb.PulsatileParams(nx=1 + 10 * (N - 2), ny=N,
                           momentum_quirk=momentum_quirk)
    state = pb.initialize(p, dtype=dtype)
    tf = max_steps or (p.beat + 2 * p.t_propagation)
    step_freq = max(1, tf // 100)
    drv = Driver(outdir, p.nx * p.ny, out_freq=step_freq,
                 vtk_freq=step_freq, async_io=async_io)
    # dump instants: POST-step times that are multiples of step_freq (the
    # reference's tf/100 cadence — the archived golden run is sol_0000000,
    # sol_0000027, …), plus the final step.  The loop advances so each
    # chunk's last step IS the next dump instant; a fixed stride of
    # step_freq from t=0 would land on t ≡ step_freq−1 and never dump.
    dumps = sorted(set(range(0, tf + 1, step_freq)) | {tf})
    it = 0                                   # next step index to run
    for dump_t in dumps:
        chunk = dump_t - it + 1
        state = pb.run(state, it, p, chunk)
        drv.clock.tick(chunk)
        it = dump_t + 1
        # fields stay ON DEVICE (async worker pulls them); Flag is dynamic
        # here (deformable walls), so it rides along as a device array too
        drv.write_vtk(dump_t, p.nx, p.ny, spacing=1.0 / p.nx,
                      scalars=[("P", state.P),
                               ("Ux", state.Ux),
                               ("Uy", state.Uy)],
                      int_scalars=[("Flag",
                                    (~state.fluid).astype(jnp.int32))])
    drv.finish()
    return state


# ─── Combustion channel (reference runCavityTwoPop :4074-4496) ─────────────
# physical time-step size and the Middleline dump times of the reference
# (CooLBM_MRT_combustion.cpp:79, :4431-4441)
CB_DELTA_T_PH = 1.0 / 48771706.22
CB_MIDDLELINE_TIMES = (0.002, 0.006)


def _combustion_vtk(drv, st, p, flags, it):
    """VTK dump with the reference's exact field list incl. velocity_Z
    (saveVtkFields, CooLBM_MRT_combustion.cpp:3560-3711; 2D run → z=0)."""
    rho, u = cb.macro_flow(st.f)
    # fields stay ON DEVICE (async worker pulls them); Flag is static host
    drv.write_vtk(it, p.nx, p.ny,
                  scalars=[("Density", rho),
                           ("Temperature", cb.macro_scalar(st.gT)),
                           ("mass_fraction_O2", cb.macro_scalar(st.gO2)),
                           ("mass_fraction_CO2", cb.macro_scalar(st.gCO2)),
                           ("velocity_X", u[0]),
                           ("velocity_Y", u[1]),
                           ("velocity_Z", np.zeros((p.ny, p.nx)))],
                  int_scalars=[("Flag", flags.astype(int))])


def run_combustion(outdir, nx=420, ny=80, dtype=jnp.float64,
                   flow_steps=20000, scalar_steps=5000, T_solid=None,
                   conj_scheme="li2014", restart=None, save_flow=True,
                   benchmark=False, bench_ini_iter=1000, bench_max_iter=2000,
                   topology="inflow_outflow", u_lid=None, dpdx=0.0):
    """Two-stage combustion driver (reference main :4074-4496).

    ``restart`` warm-starts the flow from a reference-format ``ini_f.dat``
    (Einleseoption_f, :4345 → :3129-3157), skipping the flow-convergence
    stage exactly like the reference's two-stage workflow; ``save_flow``
    writes the converged field back out (Ausgabeoption_f, :3158-3178).
    ``benchmark`` reproduces the reference bench mode (:4376-4380): flow-only
    stepping, clock reset after ``bench_ini_iter`` warmup iterations, MLUPS
    over the remaining ``bench_max_iter − bench_ini_iter``.

    ``topology`` selects the reference's compile-time domain branches
    (:154-254, :3756-4073): cavity (moving lid ``u_lid``), couette
    (moving top wall, periodic x), poiseuille (body force ``dpdx``,
    periodic x), or the default reactive inflow/outflow channel.  The
    Xu-2018 obstacles exist only in the inflow/outflow case (:3995-4029)."""
    from ..io import checkpoint as ckpt

    # a lid speed only exists for the moving-wall topologies; defaulting it
    # elsewhere would silently diverge driver-built params from a directly
    # constructed CombustionParams() (where u_lid defaults to 0.0)
    if u_lid is None:
        u_lid = 0.002 if topology in ("cavity", "couette") else 0.0
    p = cb.CombustionParams(nx=nx, ny=ny, conj_scheme=conj_scheme,
                            topology=topology, u_lid=u_lid, dpdx=dpdx,
                            with_obstacles=(topology == "inflow_outflow"))
    flags, _ = cb.build_geometry(p)
    tab = cb.build_static_tables(flags, p)

    if benchmark:
        import time

        import jax

        st = cb.initialize(p, dtype=dtype, T_solid=T_solid, flags=flags)
        st = jax.block_until_ready(cb.run(st, p, bench_ini_iter, konv=False))
        n = bench_max_iter - bench_ini_iter
        t0 = time.perf_counter()
        st = jax.block_until_ready(cb.run(st, p, n, konv=False))
        dt_s = time.perf_counter() - t0
        print(f"MLUPS: {nx * ny * n / dt_s / 1e6:.1f}")
        return st

    f0 = None
    if restart is not None:
        f0 = ckpt.load_flow_field_txt(restart)
        if f0.shape != (9, ny, nx):
            raise ValueError(
                f"restart field {f0.shape[1:]} does not match the requested "
                f"lattice ({ny}, {nx}); pass matching --ny/--nx")
    st = cb.initialize(p, dtype=dtype, T_solid=T_solid, flags=flags,
                       f_restart=f0)
    drv = Driver(outdir, nx * ny, out_freq=1000, vtk_freq=0)

    def log(done, e, dev):
        drv.log_file("energy.dat").log(done, e, dev)

    if restart is not None:
        # reference semantics: a restarted run trusts the converged field
        # and goes straight to the reactive stage (:4345, :536-542)
        done = 0
    else:
        st, done = cb.run_staged(st, p, max_flow_steps=flow_steps,
                                 check_every=500, scalar_steps=0, log=log)
        if save_flow:
            ckpt.save_flow_field_txt(f"{outdir}/ini_f.dat", st.f)

    # reactive stage, chunked so the Middleline dumps fire when the run
    # crosses the reference's fixed physical times (:4431-4441)
    it = done
    if scalar_steps > 0:
        st = cb.run(st, p, 1, konv=True, first_step=True)
        it += 1
        left = scalar_steps - 1
        while left > 0:
            chunk = min(left, 500)
            t_prev = it * CB_DELTA_T_PH
            st = cb.run(st, p, chunk, konv=True)
            it += chunk
            left -= chunk
            t_now = it * CB_DELTA_T_PH
            for t_mark in CB_MIDDLELINE_TIMES:
                if t_prev < t_mark <= t_now:
                    cb.middleline(outdir, st, tab, p, t_ph=t_mark)
    it_total = it
    cb.middleline(outdir, st, tab, p, t_ph=it_total * CB_DELTA_T_PH)

    drv.clock.tick(it_total)
    drv.log_file("thermal-energy.dat").log(
        it_total, float(cb.thermal_energy(st, tab, p)))
    cb.save_profiles(outdir, st, tab, p)
    cb.conservation_audit(outdir, st, tab, p)
    _combustion_vtk(drv, st, p, flags, it_total)
    fin, fout = cb.mass_flux_audit(st, tab, p)
    drv.log_file("conservation.dat").log(float(fin), float(fout))
    drv.finish()
    return st
