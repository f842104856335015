"""Streaming operators (pure gather formulations).

The reference implements streaming as scatter ("push") writes with on-site
bounce-back (e.g. ``laplace2D.h:260-270``, ``rayleighTaylor2D.h:532-549``) or a
serial pull loop (``PulsatileBloodFlow2D.h:603-616``).  Here both become a
vectorised *pull* (gather): the population arriving at cell ``r`` in direction
``k`` is read from the upstream cell ``r - c_k`` via ``jnp.roll``.  This is
race-free by construction and fuses into one XLA kernel.

Push-with-on-site-bounce-back is algebraically identical to the following
pull rule (derivation): for fluid cell ``i`` the reference writes
``fout(i + c_k, k) = post(i, k)`` when the neighbor is fluid, and
``fout(i, opp[k]) = post(i, k)`` when the neighbor is solid.  Therefore the
receiving fluid cell ``j`` obtains

    f_new(j, k) = post(j - c_k, k)   if fluid(j - c_k)
                  post(j, opp[k])    otherwise  (half-way bounce-back)

Solid cells keep zero populations, exactly like the reference which zeroes
them at init and never writes them.

All arrays are laid out ``(Q, y, x)`` in 2D and ``(Q, z, y, x)`` in 3D; rolls
wrap periodically on every axis.  Non-periodic axes are protected by solid
walls (as in the reference, where the wrapped/garbage reads land on wall nodes
whose populations are never used).
"""
from __future__ import annotations

import jax.numpy as jnp

from .lattice import Lattice


def _spatial_axes(lattice: Lattice):
    return tuple(range(lattice.d))


def stream_periodic(post, lattice: Lattice):
    """Pull streaming on a fully periodic domain.

    Args:
      post: post-collision populations ``(Q, [z,] y, x)``.
      lattice: velocity-set descriptor.
    Returns:
      streamed populations, same shape.
    """
    shifts = lattice.roll_shifts()
    axes = _spatial_axes(lattice)
    return jnp.stack(
        [jnp.roll(post[k], shifts[k], axis=axes) for k in range(lattice.q)],
        axis=0,
    )


def stream_bounce_back(post, fluid, lattice: Lattice):
    """Pull streaming with half-way (on-site) bounce-back at solid cells.

    Equivalent to the reference's push-stream with on-site BB
    (``laplace2D.h:260-270``): see module docstring for the derivation.

    Args:
      post: post-collision populations ``(Q, [z,] y, x)``.
      fluid: bool mask ``([z,] y, x)``, True where the cell is fluid.
      lattice: descriptor.
    Returns:
      new populations; zero at solid cells.
    """
    shifts = lattice.roll_shifts()
    opp = lattice.opp
    axes = _spatial_axes(lattice)
    out = []
    for k in range(lattice.q):
        pulled = jnp.roll(post[k], shifts[k], axis=axes)
        upstream_fluid = jnp.roll(fluid, shifts[k], axis=axes)
        out.append(jnp.where(upstream_fluid, pulled, post[opp[k]]))
    f_new = jnp.stack(out, axis=0)
    return f_new * fluid[None].astype(post.dtype)
