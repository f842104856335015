"""Tests for the SC layered-flow (const-G + p_shift) and SC-RT variants."""
import jax.numpy as jnp
import numpy as np

from multiphase_lbm_tpu.io.config import lb_parameters
from multiphase_lbm_tpu.models import shan_chen as sc
from multiphase_lbm_tpu.models import shan_chen_rt as rt


def test_p_shift_regularizes_psi():
    """config_twoLayeredFlow2D.txt preset: TT0=0.95, rhol=0.21, rhog=0.067."""
    p = sc.SCParams(TT0=0.95, rhol=0.21, rhog=0.067, rho_w=0.067,
                    psi_mode="const_g", G=-1.0)
    ps = sc.compute_p_shift(p)
    assert ps >= 0.0
    p = sc.SCParams(TT0=0.95, rhol=0.21, rhog=0.067, rho_w=0.067,
                    psi_mode="const_g", G=-1.0, p_shift=ps)
    # psi real and positive across the density range
    from multiphase_lbm_tpu.core import eos
    for r in np.linspace(p.rhog, p.rhol, 20):
        S = r / 3.0 - (float(eos.yuan_pressure(np.float64(r), p.a, p.R, p.T)) + ps)
        assert S >= -1e-10


def test_layered_flow_const_g():
    """SC layered Poiseuille: gx drive accelerates, layering persists."""
    nu, omega, dx, dt = lb_parameters(0.1, 50, 60.0)
    p0 = sc.SCParams(TT0=0.95, rhol=0.21, rhog=0.067, rho_w=0.067,
                     psi_mode="const_g", G=-1.0, omega=omega, gx_u=1e-7)
    p = dataclass_replace(p0, p_shift=sc.compute_p_shift(p0))
    nx, ny = 50, 50
    f = sc.init_layers(nx, ny, p, h_lower=0.3, w_int=4)
    fluid = sc.geometry_channel_walls(nx, ny)
    f = sc.apply_geometry(f, fluid)
    m0 = float(sc.total_mass(f, fluid))
    f = sc.run(f, fluid, p, 600)
    assert abs(float(sc.total_mass(f, fluid)) - m0) / m0 < 1e-12
    rho = np.asarray(sc.density(f))
    assert np.isfinite(rho).all()
    # liquid in the middle, gas near the walls (reference code behavior)
    assert rho[ny // 2, 10] > rho[3, 10]
    u = np.asarray(sc.u_actual(f, fluid, p))
    assert u[0][np.asarray(fluid)].mean() > 0.0


def dataclass_replace(p, **kw):
    import dataclasses
    return dataclasses.replace(p, **kw)


def test_sc_rayleigh_taylor_grows():
    p = rt.SCRTParams(omega=1.0, rhol=1.2, rhog=0.4, g=-5.0, gravity=-1.25e-5)
    nx, ny = 64, 128
    f = rt.init_interface(nx, ny, p)
    fluid = rt.geometry_channel(nx, ny)
    f = f * fluid[None].astype(f.dtype)
    rho0 = np.asarray(rt.density(f))
    f = rt.run(f, fluid, p, 1200)
    rho = np.asarray(rt.density(f))
    assert np.isfinite(rho).all()
    # spike at the cos minimum (x=nx/2) falls: heavy fluid moves down at center
    mid_profile0 = rho0[:, nx // 2]
    mid_profile1 = rho[:, nx // 2]
    y_int0 = np.argmax(mid_profile0 > 0.8)
    y_int1 = np.argmax(mid_profile1 > 0.8)
    assert y_int1 <= y_int0
    # mass conserved
    np.testing.assert_allclose(rho.sum(), rho0.sum(), rtol=1e-12)


def test_sc_rayleigh_taylor_matches_cpp_reference():
    """Quantitative regression vs an instrumented build of the C++
    reference (RayleighTaylor2D.h driver with the shipped config, VTK
    density dump at step 250 — capture protocol in BASELINE.md): the
    density profiles along the two interface probe columns must match to
    the reference's float output precision."""
    from multiphase_lbm_tpu.validation import captures

    for name, err, tol in captures.scrt_parity():
        assert err <= tol, (name, err, tol)
