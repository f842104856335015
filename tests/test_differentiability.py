"""End-to-end differentiability: adjoint sensitivities through the solver.

A JAX-native capability the C++ reference cannot provide: gradients of flow
observables with respect to physical parameters, via autodiff through the
time loop (calibration / inverse problems / control).
"""
import jax
import jax.numpy as jnp
import numpy as np

from multiphase_lbm_tpu.core.precision import einsum
from multiphase_lbm_tpu.models import shan_chen_rt as rt


def test_gradient_wrt_gravity_through_rt_solver():
    """d(kinetic energy)/d(gravity) through 30 SC-RT steps matches finite
    differences."""
    nx, ny = 32, 64
    p = rt.SCRTParams(omega=1.0, rhol=1.2, rhog=0.4, g=-5.0,
                      gravity=-1.25e-5)
    fluid = rt.geometry_channel(nx, ny)
    f0 = rt.init_interface(nx, ny, p) * fluid[None]
    c = jnp.asarray(rt.D2Q9.c, f0.dtype)

    @jax.jit
    def energy(gravity):
        def body(f, _):
            return rt.step_with_gravity(f, fluid, p, gravity), None
        f, _ = jax.lax.scan(body, f0, None, length=30)
        rho = rt.density(f)
        # HIGHEST-precision einsum: this gradient is checked against
        # finite differences, so reduced-precision (TF32) products would bite
        u = einsum("kd,kyx->dyx", c, f) / jnp.maximum(rho, 1e-14)[None]
        return 0.5 * jnp.sum(jnp.where(fluid[None], u, 0.0) ** 2)

    g0 = -1.25e-5
    grad = jax.grad(energy)(g0)
    assert np.isfinite(float(grad)) and float(grad) != 0.0
    h = 1e-8
    fd = (energy(g0 + h) - energy(g0 - h)) / (2 * h)
    np.testing.assert_allclose(float(grad), float(fd), rtol=1e-4)
