"""Combustion solver tests (scaled-down Xu-2018 channel)."""
import dataclasses
import jax.numpy as jnp

import jax.numpy as jnp
import numpy as np
import pytest

from multiphase_lbm_tpu.models import combustion as cb


@pytest.fixture(scope="module")
def small():
    p = cb.CombustionParams(nx=260, ny=48)
    flags, f_solid = cb.build_geometry(p)
    tab = cb.build_static_tables(flags, p)
    return p, flags, f_solid, tab


def test_geometry(small):
    p, flags, f_solid, tab = small
    assert (flags[:, 0] == cb.WALL).all()          # inlet momentum-exchange wall
    assert (flags[0] == cb.WALL).all() and (flags[-1] == cb.WALL).all()
    assert (flags == cb.OBSTACLE).sum() > 0
    # inlet populations encode the parabolic profile (peak mid-channel)
    k_east = 1
    prof = -f_solid[k_east, :, 0] / (6.0 * cb.W[k_east])
    assert prof.max() == pytest.approx(p.u_inlet, rel=1e-3)
    assert prof[1] < prof[p.ny // 2]


def test_interface_normals_flat_faces(small):
    p, flags, f_solid, tab = small
    # gas cell immediately left of the first obstacle (x=99): its +x axis
    # link crosses into the obstacle; normal must be -c_1 = (-1, 0)
    ys = int(p.ny * 3 / 8) + 2
    assert tab["nb_obst"][1][ys, 99]
    # ck_n for k=1 is c.(-c) = -1 on flat faces
    assert tab["ck_n"][1][ys, 99] == pytest.approx(-1.0)


def test_flow_converges_and_conserves_flux():
    # Obstacle-free channel: at the test shape 128×48 the obstacle wake
    # reaches the extrapolated outlet and feeds a slow instability (max|ux|
    # doubles every ~1500 steps past ~5000) — REFERENCE-FAITHFUL, verified
    # against a 6000-step flow-only run of the instrumented C++ (identical
    # growth to float precision; see BASELINE.md).  The convergence/flux
    # machinery is exercised on the stable obstacle-free configuration.
    p = cb.CombustionParams(nx=128, ny=48, with_obstacles=False)
    flags, f_solid = cb.build_geometry(p)
    tab = cb.build_static_tables(flags, p)
    st = cb.initialize(p)
    st, done = cb.run_staged(st, p, max_flow_steps=20000, check_every=500,
                             tol=1e-4)
    rho, u = cb.macro_flow(st.f)
    ux = np.asarray(u[0])
    bulk = tab["is_bulk"]
    assert np.isfinite(ux[bulk]).all()
    # inlet profile approximately parabolic with the target peak
    prof = ux[:, 2]
    assert prof[p.ny // 2] == pytest.approx(p.u_inlet, rel=0.25)
    # mass flux audit: inflow ~ outflow
    fin, fout = cb.mass_flux_audit(st, tab, p)
    assert float(fin) > 0
    assert abs(float(fout) - float(fin)) / float(fin) < 0.05


def test_species_advect_from_inlet(small):
    p, flags, f_solid, tab = small
    st = cb.initialize(p)
    st = cb.run(st, p, 1500, konv=False)
    st = cb.run(st, p, 1, konv=True, first_step=True)
    st = cb.run(st, p, 800, konv=True)
    Y = np.asarray(cb.macro_scalar(st.gO2))
    # upstream bulk cell saturates toward the inlet value; far downstream
    # still near zero
    assert Y[p.ny // 2, 3] > 0.8 * p.Y_O2_inlet
    assert Y[p.ny // 2, p.nx - 5] < 0.05
    assert np.isfinite(Y[tab["is_bulk"]]).all()


def test_conjugate_heat_and_reaction(small):
    """Hot obstacle: conjugate transfer warms adjacent gas; the Arrhenius
    surface reaction consumes O2 and produces CO2 at the interface."""
    p, flags, f_solid, tab = small
    st = cb.initialize(p, T_solid=2.0, flags=flags)
    st = cb.run(st, p, 400, konv=False)
    st = cb.run(st, p, 1, konv=True, first_step=True)
    st = cb.run(st, p, 1200, konv=True)
    T = np.asarray(cb.macro_scalar(st.gT))
    Y1 = np.asarray(cb.macro_scalar(st.gO2))
    Y2 = np.asarray(cb.macro_scalar(st.gCO2))
    ys = int(p.ny * 3 / 8) + 2
    # gas next to the hot obstacle is warmer than gas far from it
    assert T[ys, 99] > T[2, 50] + 1e-4
    assert np.isfinite(T[tab["is_bulk"]]).all()
    # reaction produces CO2 somewhere
    assert Y2[tab["is_bulk"]].max() > 1e-9
    # solid stays hot-ish (huge heat capacity ratio)
    assert np.asarray(cb.macro_scalar(st.gT))[tab["is_obst"]].min() > 1.5


def test_no_reaction_mode(small):
    p0, flags, f_solid, tab = small
    p = dataclasses.replace(p0, solid_reaction=False)
    st = cb.initialize(p, T_solid=2.0, flags=flags)
    st = cb.run(st, p, 200, konv=False)
    st = cb.run(st, p, 1, konv=True, first_step=True)
    st = cb.run(st, p, 300, konv=True)
    Y2 = np.asarray(cb.macro_scalar(st.gCO2))
    assert abs(Y2[tab["is_bulk"]]).max() < 1e-12   # no CO2 source


def test_freeslip_walls():
    """Specular y-walls: flow slips (no wall drag ⇒ near-plug profile)."""
    p = cb.CombustionParams(nx=260, ny=48, y_freeslip=True,
                            with_obstacles=False)
    flags, f_solid = cb.build_geometry(p)
    tab = cb.build_static_tables(flags, p)
    st = cb.initialize(p)
    st = cb.run(st, p, 2500, konv=False)
    rho, u = cb.macro_flow(st.f)
    ux = np.asarray(u[0])
    # downstream of the inlet, the near-wall velocity stays much closer to
    # the centerline value than with no-slip walls
    x = 150
    assert np.isfinite(ux[tab["is_bulk"]]).all()
    ratio = ux[1, x] / ux[p.ny // 2, x]
    assert ratio > 0.6, ratio


def test_temperature_coupling_runs():
    """TC=1 corrector path compiles and stays finite."""
    p = cb.CombustionParams(nx=260, ny=48, temperature_coupling=True)
    flags, _ = cb.build_geometry(p)
    tab = cb.build_static_tables(flags, p)
    st = cb.initialize(p, T_solid=1.5, flags=flags)
    st = cb.run(st, p, 100, konv=False)
    st = cb.run(st, p, 1, konv=True, first_step=True)
    st = cb.run(st, p, 200, konv=True)
    T = np.asarray(cb.macro_scalar(st.gT))
    assert np.isfinite(T[tab["is_bulk"]]).all()


def test_profile_outputs(small, tmp_path):
    p, flags, f_solid, tab = small
    st = cb.initialize(p)
    st = cb.run(st, p, 200, konv=False)
    cb.save_profiles(tmp_path, st, tab, p)
    cb.save_slice(tmp_path, st, p)
    cb.middleline(tmp_path, st, tab, p, t_ph=0.002)
    cb.conservation_audit(tmp_path, st, tab, p)
    import os
    for f in ("middlex.dat", "middley.dat", "vx.dat", "rho.dat",
              "velocity_middleline_000.002.dat",
              "inlet_massflow.dat", "inlet_massflow_names.dat",
              "outlet_massflow.dat", "outlet_massflow_names.dat",
              "inlet_momentumflow.dat", "outlet_momentumflow.dat",
              "inlet_momentumflow_names.dat", "outlet_momentumflow_names.dat",
              "massflow_Komp_inlet_outlet.dat",
              "conservation_totals.dat"):
        assert os.path.exists(tmp_path / f), f
    # middleline schema: 6 columns, nx rows, x=0 row carries inlet values
    ml = np.loadtxt(tmp_path / "velocity_middleline_000.002.dat")
    assert ml.shape == (p.nx, 6)
    assert ml[0, 3] == p.T_inlet and ml[0, 4] == p.Y_O2_inlet


def test_cavity_topology():
    """Lid-driven cavity: moving lid drags the fluid into a vortex."""
    p = cb.CombustionParams(nx=64, ny=64, topology="cavity", u_lid=0.05,
                            with_obstacles=False)
    flags, f_solid = cb.build_geometry(p)
    tab = cb.build_static_tables(flags, p)
    st = cb.initialize(p)
    st = cb.run(st, p, 3000, konv=False)
    rho, u = cb.macro_flow(st.f)
    ux = np.asarray(u[0])
    assert np.isfinite(ux[tab["is_bulk"]]).all()
    # fluid just under the lid follows it; bottom recirculates backwards
    assert ux[-2, 32] > 0.01
    assert ux[8, 32] < 0.0


def test_poiseuille_topology():
    """Body-force Poiseuille: parabolic profile with the analytic peak."""
    p = cb.CombustionParams(nx=64, ny=34, topology="poiseuille",
                            dpdx=1e-6, tau_flow=0.8, with_obstacles=False)
    flags, f_solid = cb.build_geometry(p)
    tab = cb.build_static_tables(flags, p)
    st = cb.initialize(p)
    st = cb.run(st, p, 8000, konv=False)
    rho, u = cb.macro_flow(st.f)
    ux = np.asarray(u[0])
    H = p.ny - 2
    nu = (p.tau_flow - 0.5) / 3.0
    u_max = p.dpdx * (H / 2.0) ** 2 / (2.0 * nu)
    assert ux[p.ny // 2, 32] == pytest.approx(u_max, rel=0.1)
    # symmetric profile
    assert ux[5, 32] == pytest.approx(ux[p.ny - 6, 32], rel=0.05)


def test_couette_topology():
    p = cb.CombustionParams(nx=64, ny=34, topology="couette", u_lid=0.04,
                            with_obstacles=False)
    flags, f_solid = cb.build_geometry(p)
    tab = cb.build_static_tables(flags, p)
    st = cb.initialize(p)
    st = cb.run(st, p, 6000, konv=False)
    rho, u = cb.macro_flow(st.f)
    ux = np.asarray(u[0])
    # linear shear: midpoint ≈ half the lid speed
    assert ux[p.ny // 2, 32] == pytest.approx(p.u_lid / 2.0, rel=0.15)


def test_guo2015_conjugate_scheme(small):
    """GUO2015: reaction heat deposits into the solid q-store; interfaces
    pass populations through.  Hot gas (T=2) makes the Arrhenius rate
    non-negligible."""
    p = cb.CombustionParams(nx=128, ny=48, conj_scheme="guo2015",
                            T_ini=2.0, T_inlet=2.0, with_obstacles=False)
    p_off = dataclasses.replace(p, solid_reaction=False)
    # custom obstacle near the inlet so O2 reaches it quickly
    flags, f_solid = cb.build_geometry(p)
    flags = flags.copy()
    flags[18:30, 20:30] = cb.OBSTACLE
    tab = cb.build_static_tables(flags, p)

    def run_case(pp):
        step1, _ = cb.make_step(pp, flags=flags, f_solid=f_solid, konv=True,
                                first_step=True)
        stepn, _ = cb.make_step(pp, flags=flags, f_solid=f_solid, konv=True)
        stepf, _ = cb.make_step(pp, flags=flags, f_solid=f_solid, konv=False)
        st = cb.initialize(pp, T_solid=2.0, flags=flags)
        import jax
        @jax.jit
        def flow200(s):
            return jax.lax.scan(lambda c_, _: (stepf(c_), None), s, None,
                                length=200)[0]
        @jax.jit
        def react400(s):
            return jax.lax.scan(lambda c_, _: (stepn(c_), None), s, None,
                                length=400)[0]
        st = flow200(st)
        st = step1(st)
        st = react400(st)
        return st
    st_on = run_case(p)
    st_off = run_case(p_off)
    T_on = np.asarray(cb.macro_scalar(st_on.gT))
    T_off = np.asarray(cb.macro_scalar(st_off.gT))
    assert np.isfinite(T_on[tab["is_bulk"]]).all()
    # reaction heat raises the solid relative to the no-reaction run
    assert (T_on[tab["is_obst"]].sum() - T_off[tab["is_obst"]].sum()) > 1e-6
    # q store actively carries deposits
    assert float(jnp.abs(st_on.q_heat).max()) > 0.0


def test_huber2015_conjugate_scheme(small):
    """HUBER2015: passthrough streaming + Karani forcing F = q·∇(1/ρcp).
    The forcing only acts at bulk cells bordering the obstacle, so away from
    solids the scheme must match "none"; near the obstacle it must differ,
    and the gas-side reaction heat (F_Q1, :2861) must raise T like LI2014."""
    p = cb.CombustionParams(nx=128, ny=48, conj_scheme="huber2015",
                            T_ini=2.0, T_inlet=2.0, with_obstacles=False)
    flags, f_solid = cb.build_geometry(p)
    flags = flags.copy()
    flags[18:30, 20:30] = cb.OBSTACLE
    tab = cb.build_static_tables(flags, p)

    def run_case(pp):
        step1, _ = cb.make_step(pp, flags=flags, f_solid=f_solid, konv=True,
                                first_step=True)
        stepn, _ = cb.make_step(pp, flags=flags, f_solid=f_solid, konv=True)
        stepf, _ = cb.make_step(pp, flags=flags, f_solid=f_solid, konv=False)
        st = cb.initialize(pp, T_solid=2.0, flags=flags)
        import jax

        @jax.jit
        def flow200(s):
            return jax.lax.scan(lambda c_, _: (stepf(c_), None), s, None,
                                length=200)[0]

        @jax.jit
        def react300(s):
            return jax.lax.scan(lambda c_, _: (stepn(c_), None), s, None,
                                length=300)[0]
        st = flow200(st)
        st = step1(st)
        return react300(st)

    st_h = run_case(p)
    st_n = run_case(dataclasses.replace(p, conj_scheme="none"))
    T_h = np.asarray(cb.macro_scalar(st_h.gT))
    T_n = np.asarray(cb.macro_scalar(st_n.gT))
    assert np.isfinite(T_h[tab["is_bulk"] | tab["is_obst"]]).all()
    # the conjugate forcing + gas-side reaction heat change the field
    assert np.abs(T_h - T_n)[tab["is_bulk"]].max() > 1e-9
    # reaction heating: huber gas near the obstacle hotter than passthrough
    near = tab["is_bulk"] & (tab["nb_obst"][1] | tab["nb_obst"][2]
                             | tab["nb_obst"][3] | tab["nb_obst"][4])
    assert T_h[near].sum() > T_n[near].sum()


def test_huber2015_reduces_to_none_without_obstacles(small):
    """With no solid cells every Huber mask is empty, so huber2015 and the
    plain passthrough scheme must agree bit-for-bit."""
    p = cb.CombustionParams(nx=64, ny=32, conj_scheme="huber2015",
                            with_obstacles=False, T_ini=1.5, T_inlet=1.5)
    st_h = cb.run(cb.initialize(p), p, 40, konv=True, first_step=True)
    p2 = dataclasses.replace(p, conj_scheme="none")
    st_n = cb.run(cb.initialize(p2), p2, 40, konv=True, first_step=True)
    np.testing.assert_array_equal(np.asarray(st_h.gT), np.asarray(st_n.gT))
    np.testing.assert_array_equal(np.asarray(st_h.f), np.asarray(st_n.f))


@pytest.mark.parametrize("topology,extra", [
    ("cavity", ["--u-lid", "0.01"]),
    ("couette", ["--u-lid", "0.01"]),
    ("poiseuille", ["--dpdx", "1e-6"]),
])
def test_cli_topology_smoke(topology, extra, tmp_path):
    """Each reference domain branch (CooLBM_MRT_combustion.cpp:154-254,
    :3756-4073) is reachable from the CLI: the run completes, stays
    finite, and emits the audit/VTK set."""
    from multiphase_lbm_tpu.runners import coolbm

    outdir = tmp_path / "out"
    outdir.mkdir()
    rc = coolbm.main(["combustion", "--topology", topology,
                      "--nx", "48", "--ny", "16",
                      "--steps", "30", "--scalar-steps", "5",
                      "--outdir", str(outdir), *extra])
    assert rc == 0
    assert list(outdir.glob("sol_*.vtk"))


def test_cli_restart_workflow(tmp_path):
    """Two-stage CLI round trip (reference :4345, :3129-3178): run the flow
    stage once, write ini_f.dat, then a --restart run consumes it and skips
    straight to the reactive stage."""
    from multiphase_lbm_tpu.runners import apps

    out1 = tmp_path / "stage1"
    out1.mkdir()
    apps.run_combustion(str(out1), nx=96, ny=48, flow_steps=600,
                        scalar_steps=40)
    assert (out1 / "ini_f.dat").exists()
    out2 = tmp_path / "stage2"
    out2.mkdir()
    st = apps.run_combustion(str(out2), nx=96, ny=48, scalar_steps=40,
                             restart=str(out1 / "ini_f.dat"))
    assert np.isfinite(np.asarray(st.f)).all()
    # the restarted run must have produced the audit + middleline + vtk set
    assert (out2 / "inlet_massflow.dat").exists()
    assert list(out2.glob("velocity_middleline_*.dat"))
    vtk = list(out2.glob("sol_*.vtk"))
    assert vtk and "velocity_Z" in vtk[0].read_text()


def test_bench_auto_falls_back_to_xla_on_unsupported_config(tmp_path, capsys):
    """--bench (reference protocol :4376-4380: warm-up, then a timed
    flow-only window) runs the model's XLA step for every conjugate
    scheme, guo2015 included, and prints its MLUPS line."""
    from multiphase_lbm_tpu.runners import apps

    st = apps.run_combustion(str(tmp_path), nx=64, ny=32, benchmark=True,
                             bench_ini_iter=5, bench_max_iter=10,
                             conj_scheme="guo2015")
    assert np.isfinite(np.asarray(st.f)).all()
    assert capsys.readouterr().out.startswith("MLUPS: ")
