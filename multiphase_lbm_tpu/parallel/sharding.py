"""Multi-device lattice decomposition (jit / shard_map over a device Mesh).

The reference has no distributed layer (single-process parallel STL,
SURVEY §2.5); here the lattice is cut over a device mesh whose axes are
named after the lattice axes they cut: mesh axis 'x' cuts the last
(x) axis, 'y' the one before it.

Two paths:

* **auto** (:func:`shard_state`): jit the unmodified global step with
  ``NamedSharding`` inputs and let XLA GSPMD turn the streaming rolls into
  collective-permutes.  Works for every family, including steps that are
  not translation invariant (combustion's inlet/outlet columns, the
  pulsatile vessel's wall geometry) and D3Q19 volumes.
* **halo** (:func:`make_halo_step`): ``shard_map`` wrapper that exchanges a
  ``width``-cell halo with ring ``lax.ppermute``, runs the *unmodified*
  local step on the halo-extended block, and crops.  Correct for any
  translation-invariant 2D step whose total stencil reach ≤ ``width``
  (SC: force 1 + stream 1 = 2; HCZ: ∇∇² needs 2 + stream 1 = 3).
  Periodic global topology falls out of the permute ring.  It exchanges
  once per step.
"""
from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, shape=None, axis_names=("x",)):
    """1D (or 2D) device mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = np.array(devs[:n_devices])
    if shape is None:
        shape = (n_devices,)
    return Mesh(devs.reshape(shape), axis_names)


# mesh axis name -> the lattice axis it cuts (spatial axes are last)
_AXES = (("x", -1), ("y", -2))


def lattice_pspec(mesh: Mesh, ndim_spatial: int = 2, leading: int = 1):
    """PartitionSpec sharding the x axis (last) along mesh axis 'x' and the
    y axis along mesh axis 'y', for whichever of the two the mesh has.
    ``leading`` counts leading population/component axes that stay
    replicated."""
    spec = [None] * (leading + ndim_spatial)
    for name, ax in _AXES:
        if name in mesh.axis_names:
            spec[ax] = name
    return P(*spec)


def shard_lattice(arr, mesh: Mesh, leading: int = 1):
    """Place a global array with the standard lattice sharding."""
    ndim_spatial = arr.ndim - leading
    return jax.device_put(arr, NamedSharding(mesh, lattice_pspec(mesh, ndim_spatial, leading)))


def shard_state(state, mesh: Mesh):
    """Place every array of a model state (any pytree) for the auto path:
    the two trailing axes of each array of rank ≥ 2 are cut along mesh
    axes 'x'/'y' where the mesh axis divides them; everything else (wall
    position vectors, halo-padded geometry fields of odd size, scalars)
    is replicated.  The unmodified jitted step then runs under GSPMD."""
    def place(a):
        spec = [None] * a.ndim
        if a.ndim >= 2:
            for name, ax in _AXES:
                if (name in mesh.axis_names
                        and a.shape[ax] % mesh.shape[name] == 0):
                    spec[ax] = name
        return jax.device_put(a, NamedSharding(mesh, P(*spec)))
    return jax.tree_util.tree_map(place, state)


# ─── halo exchange ─────────────────────────────────────────────────────────
def _exchange_axis(x, width: int, axis: int, axis_name: str):
    """Append neighbor halos on ``axis``: returns the local block extended by
    ``width`` cells on each side, filled via ring ppermute (periodic)."""
    n = lax.axis_size(axis_name)
    idx = [slice(None)] * x.ndim

    idx_r = list(idx)
    idx_r[axis] = slice(x.shape[axis] - width, x.shape[axis])
    right_edge = x[tuple(idx_r)]
    idx_l = list(idx)
    idx_l[axis] = slice(0, width)
    left_edge = x[tuple(idx_l)]

    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    # halo that sits to my LEFT is my left neighbor's right edge
    left_halo = lax.ppermute(right_edge, axis_name, fwd)
    # halo to my RIGHT is my right neighbor's left edge
    right_halo = lax.ppermute(left_edge, axis_name, bwd)
    return jnp.concatenate([left_halo, x, right_halo], axis=axis)


def _crop_axis(x, width: int, axis: int):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(width, x.shape[axis] - width)
    return x[tuple(idx)]


def make_halo_step(step_fn: Callable, mesh: Mesh, width: int,
                   state_leading: Sequence[int], n_state: int = 1):
    """Wrap a *global* step function into a shard_map halo-exchange step.

    Args:
      step_fn: ``step_fn(*arrays) -> array or tuple`` where every argument and
        result is lattice-shaped (spatial axes last).  Rolls inside may wrap at
        block edges — only the halo region is affected and it gets cropped.
      mesh: device mesh with axis 'x' (and optionally 'y').
      width: halo width ≥ the step's total stencil reach.
      state_leading: number of leading non-spatial axes for each argument.
      n_state: how many of the leading results are lattice-shaped outputs.

    Returns a jitted function with the same signature as ``step_fn``.
    """
    axes = [(name, ax) for name, ax in _AXES if name in mesh.axis_names]

    def local_step(*args):
        ext = []
        for a, lead in zip(args, state_leading):
            for ax_name, ax in axes:
                a = _exchange_axis(a, width, a.ndim + ax if ax < 0 else ax, ax_name)
            ext.append(a)
        out = step_fn(*ext)
        single = not isinstance(out, tuple)
        outs = (out,) if single else out
        cropped = []
        for o in outs[:n_state]:
            for ax_name, ax in axes:
                o = _crop_axis(o, width, o.ndim + ax if ax < 0 else ax)
            cropped.append(o)
        cropped.extend(outs[n_state:])
        return cropped[0] if single else tuple(cropped)

    specs = tuple(lattice_pspec(mesh, 2, lead) for lead in state_leading)
    out_specs_state = tuple(lattice_pspec(mesh, 2, 1) for _ in range(n_state))

    # out spec: assume state outputs keep one leading axis (populations)
    shard_fn = jax.shard_map(
        local_step, mesh=mesh, in_specs=specs,
        out_specs=out_specs_state[0] if n_state == 1 else out_specs_state,
        check_vma=False)
    return jax.jit(shard_fn)
