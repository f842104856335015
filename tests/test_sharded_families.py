"""Sharded equals single-device, per model family, on the 8-device virtual
CPU mesh: a 1D mesh of 4 (cutting x) and a 2×2 mesh (cutting y and x).

Translation-invariant 2D steps run the shard_map halo path
(``make_halo_step``, width ≥ the step's stencil reach); steps with
absolute-position boundary columns (combustion), a wall geometry coupled
along the whole vessel (pulsatile) or a D3Q19 volume run the GSPMD auto
path (``shard_state``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from multiphase_lbm_tpu.models import fakhari as fk
from multiphase_lbm_tpu.models import hcz
from multiphase_lbm_tpu.models import registry
from multiphase_lbm_tpu.models import shan_chen_rt as rt
from multiphase_lbm_tpu.parallel import sharding as sh

STEPS = 3
MESHES = {"1d": ((4,), ("x",)), "2x2": ((2, 2), ("y", "x"))}


def _mesh(kind):
    shape, names = MESHES[kind]
    return Mesh(np.array(jax.devices()[:4]).reshape(shape), names)


def _close(got, want):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-12, atol=1e-14)


# family -> (shape, halo width, global step over lattice-shaped arrays,
#            leading axes of each array)
def _scrt():
    p = rt.SCRTParams()
    fl = rt.geometry_channel(16, 66)
    f = rt.init_interface(16, 66, p, dtype=jnp.float64) * fl[None]
    return (f, fl), 2, lambda f, m: rt.step(f, m, p), (1, 0), 1


def _hcz():
    p = hcz.HCZParams()
    fl = hcz.geometry_channel(16, 66)
    f, g = hcz.apply_geometry(
        hcz.init_rayleigh_taylor(16, 66, p, dtype=jnp.float64), fl)
    return ((f, g, fl), 3,
            lambda f, g, m: tuple(hcz.step_2d((f, g), m, p)), (1, 1, 0), 2)


def _fakhari():
    p = fk.FakhariParams()
    st = tuple(fk.init_bubble(32, 32, p, dtype=jnp.float64))
    return (st, 3, lambda h, g, u: tuple(fk.step((h, g, u), p)),
            (1, 1, 1), 3)


HALO = {"scrt": _scrt, "hcz": _hcz, "fakhari": _fakhari}
AUTO = {"hcz3d": (8, 8, 16), "combustion": (16, 48), "pulsatile": (16, 160)}


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("family", sorted(HALO))
def test_halo_path_matches_single_device(family, kind, eight_devices):
    args, width, gstep, leading, n_state = HALO[family]()
    mesh = _mesh(kind)
    step = sh.make_halo_step(gstep, mesh, width=width,
                             state_leading=leading, n_state=n_state)
    sharded = [sh.shard_lattice(a, mesh, leading=lead)
               for a, lead in zip(args, leading)]
    static = sharded[n_state:]
    want, got = args[:n_state], sharded[:n_state]
    for _ in range(STEPS):
        want = gstep(*want, *args[n_state:])
        want = want if isinstance(want, tuple) else (want,)
        got = step(*got, *static)
        got = got if isinstance(got, tuple) else (got,)
    _close(got, want)


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("family", sorted(AUTO))
def test_auto_path_matches_single_device(family, kind, eight_devices):
    sim = registry.build(family, AUTO[family], jnp.float64)
    mesh = _mesh(kind)
    sharded = sh.shard_state(sim.state, mesh)
    cut = [s.sharding.spec for s in jax.tree_util.tree_leaves(sharded)]
    assert any(any(ax is not None for ax in spec) for spec in cut)
    _close(sim.run(sharded, STEPS), sim.run(sim.state, STEPS))
