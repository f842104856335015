"""Float32-exact einsum for population/moment contractions.

On an NVIDIA H100, XLA may run a float32 contraction on the tensor cores
in TF32 (10 stored mantissa bits, about three decimal digits) unless the
call asks for more.  The k=9/19 population sums against the lattice ``c``
matrix (``cu = einsum("kd,d...->k...", c, u)``) and the 9×9 MRT moment
products (``core.collision.mrt_collide``) would then carry a relative
error near 1e-3 into every step, which compounds to O(1) field divergence
within a few hundred steps of an unstable flow (Rayleigh–Taylor) and
breaks the C++ capture gates, which hold the reference's float-print
precision.

``einsum`` here pins ``precision=HIGHEST``: true float32 (or float64)
arithmetic on every backend.  Every contraction in ``core/`` and
``models/`` goes through it; ``tests/test_family_invariants.py`` checks
that each family's step jaxpr holds no ``dot_general`` at a lower
precision.  On the CPU and in float64 the pin changes nothing.
"""
from functools import partial

import jax
import jax.numpy as jnp

einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
