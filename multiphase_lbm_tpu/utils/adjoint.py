"""Memory-efficient adjoints: √n rematerialization through the time loop.

Differentiating a ``lax.scan`` time loop (validation/calibration.py,
tests/test_differentiability.py) makes XLA save EVERY intermediate lattice
state for the backward pass — O(n_steps · state_bytes) of device memory:
a 2048² D2Q9 f32 state is 151 MB, so an 80 GB card holds about 500 saved
steps (computed from shapes).  :func:`scan_remat`
nests two scans and wraps the inner one in ``jax.checkpoint``: only the
O(√n) outer-block boundary states are saved, and each inner block is
recomputed during the backward sweep (the classic √n checkpointing
trade — ~2× forward FLOPs for a √n-factor memory cut; the task-level
recipe "use jax.checkpoint to trade FLOPs for memory").

The C++ reference has no adjoint capability at all (imperative in-place
loops, e.g. ``Phase field model/apps/rayleighTaylor2D.h:980``); this is
native to the functional JAX design.  Works for any pytree state and any
pure ``step`` function — the XLA model paths.  Adjoint gradients are
checked against finite differences, so the contractions stay at HIGHEST
precision (``core/precision.py``).
"""
from __future__ import annotations

import math

import jax
from jax import lax


def scan_remat(step, state, n_steps: int, block: int = 0):
    """Advance ``state`` by ``n_steps`` applications of ``step`` (a pure
    ``state -> state`` function), differentiable with O(√n) saved states.

    ``block`` is the inner-scan length (states inside a block are
    rematerialized on the backward pass); defaults to ⌈√n_steps⌉.  The
    remainder ``n_steps % block`` runs as a plain trailing scan — it is
    at most ``block-1`` steps, so its saved states stay within the same
    O(√n) envelope.  Forward-only callers should keep using plain
    ``lax.scan`` (models' ``run``): under ``jax.jit`` without ``grad``
    the checkpoint decorator is a no-op but the nested scan still
    compiles two loops.
    """
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if block <= 0:
        block = max(1, math.isqrt(max(n_steps, 1) - 1) + 1)
    n_outer, rem = divmod(n_steps, block)

    def body(s, _):
        return step(s), None

    @jax.checkpoint
    def inner(s):
        s, _ = lax.scan(body, s, None, length=block)
        return s

    def outer(s, _):
        return inner(s), None

    if n_outer:
        state, _ = lax.scan(outer, state, None, length=n_outer)
    if rem:
        state, _ = lax.scan(body, state, None, length=rem)
    return state
