"""One build function per model family: its benchmark configuration at any
lattice shape and dtype.

``build(family, shape, dtype)`` returns a :class:`Sim` whose ``run`` is
the family's jitted XLA time loop and whose ``step`` is one step of the
same update, so callers (the benchmark suite, ``chip_smoke.py``, the
tests) never rebuild a family's parameters, geometry or initial state
themselves.  ``shape`` is the lattice shape without the population axis:
``(ny, nx)`` or, for ``hcz3d``, ``(nz, ny, nx)``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp


class Sim(NamedTuple):
    state: object           # initial state (array or tuple of arrays)
    run: Callable           # run(state, n, t0=0) -> state after n steps
    step: Callable          # step(state, t) -> state after one step
    observable: Callable    # state -> the field compared across dtypes


def _sc(shape, dtype):
    from . import shan_chen as sc

    ny, nx = shape
    p = sc.SCParams(collision="mrt")
    fl = sc.geometry_periodic(nx, ny)
    f = sc.init_droplet(nx, ny, p, radius=min(nx, ny) / 8.0, dtype=dtype)
    return Sim(f, lambda s, n, t0=0: sc.run(s, fl, p, n),
               lambda s, t: sc.step(s, fl, p), sc.density)


def _scrt(shape, dtype):
    from . import shan_chen_rt as rt

    ny, nx = shape
    p = rt.SCRTParams()
    fl = rt.geometry_channel(nx, ny)
    f = rt.init_interface(nx, ny, p, dtype=dtype) * fl[None].astype(dtype)
    return Sim(f, lambda s, n, t0=0: rt.run(s, fl, p, n),
               lambda s, t: rt.step(s, fl, p), rt.density)


def _hcz(shape, dtype):
    from . import hcz

    ny, nx = shape
    p = hcz.HCZParams()
    fl = hcz.geometry_channel(nx, ny)
    st = hcz.apply_geometry(hcz.init_rayleigh_taylor(nx, ny, p, dtype=dtype),
                            fl)
    return Sim(st, lambda s, n, t0=0: hcz.run(s, fl, p, n),
               lambda s, t: hcz.step_2d(s, fl, p),
               lambda s: hcz.order_parameter(s[0]))


def _hcz3d(shape, dtype):
    from . import hcz

    nz, ny, nx = shape
    p = hcz.HCZParams()
    fl = hcz.geometry_periodic_3d(nx, ny, nz)
    st = hcz.init_droplet_3d(nx, ny, nz, p, dtype=dtype)
    return Sim(st,
               lambda s, n, t0=0: hcz.run(s, fl, p, n, lattice=hcz.D3Q19,
                                          three_d=True),
               lambda s, t: hcz.step_3d(s, fl, p),
               lambda s: hcz.order_parameter(s[0]))


def _fakhari(shape, dtype):
    from . import fakhari as fk

    ny, nx = shape
    p = fk.FakhariParams()
    st = tuple(fk.init_bubble(nx, ny, p, dtype=dtype))
    return Sim(st, lambda s, n, t0=0: fk.run(s, p, n),
               lambda s, t: fk.step(s, p), fk.phase_field)


def _combustion(shape, dtype):
    from . import combustion as cb

    ny, nx = shape
    p = cb.CombustionParams(nx=nx, ny=ny)
    st = cb.run(cb.initialize(p, dtype=dtype), p, 1, first_step=True)
    step, _ = cb.make_step(p)
    return Sim(st, lambda s, n, t0=0: cb.run(s, p, n),
               lambda s, t: step(s), lambda s: cb.macro_scalar(s.gT))


def _pulsatile(shape, dtype, deformable=True):
    from . import pulsatile as pm

    ny, nx = shape
    p = pm.PulsatileParams(nx=nx, ny=ny, deformable=deformable)
    st = pm.initialize(p, dtype=dtype)
    return Sim(st, lambda s, n, t0=0: pm.run(s, t0, p, n),
               lambda s, t: pm.step(s, t, p), lambda s: s.P)


FAMILIES = {
    "sc": _sc,
    "scrt": _scrt,
    "hcz": _hcz,
    "hcz3d": _hcz3d,
    "fakhari": _fakhari,
    "combustion": _combustion,
    "pulsatile": _pulsatile,
}


def build(family: str, shape, dtype=jnp.float32, **kw) -> Sim:
    """``kw``: family-specific options (``deformable`` for pulsatile)."""
    return FAMILIES[family](tuple(shape), dtype, **kw)
