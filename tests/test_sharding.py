"""Multi-device decomposition tests on the 8-device virtual CPU mesh."""
import jax.numpy as jnp
import numpy as np
import pytest

from multiphase_lbm_tpu.models import shan_chen as sc
from multiphase_lbm_tpu.parallel import sharding as sh


@pytest.fixture(scope="module")
def setup():
    p = sc.SCParams()
    nx, ny = 64, 32
    f = sc.init_droplet(nx, ny, p, radius=6.0, dtype=jnp.float64)
    fluid = sc.geometry_channel_walls(nx, ny)
    f = sc.apply_geometry(f, fluid)
    return p, f, fluid


def test_auto_sharding_matches_single_device(setup, eight_devices):
    p, f, fluid = setup
    ref = sc.run(f, fluid, p, 10)

    mesh = sh.make_mesh(4)
    f_sh = sh.shard_lattice(f, mesh, leading=1)
    fluid_sh = sh.shard_lattice(fluid, mesh, leading=0)
    out = sc.run(f_sh, fluid_sh, p, 10)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-13)


def test_halo_step_matches_global_step(setup, eight_devices):
    p, f, fluid = setup
    mesh = sh.make_mesh(4)

    def gstep(fa, fl):
        return sc.step(fa, fl, p)

    halo_step = sh.make_halo_step(gstep, mesh, width=2,
                                  state_leading=(1, 0), n_state=1)
    f_sh = sh.shard_lattice(f, mesh, leading=1)
    fluid_sh = sh.shard_lattice(fluid, mesh, leading=0)

    ref = f
    out = f_sh
    for _ in range(5):
        ref = sc.step(ref, fluid, p)
        out = halo_step(out, fluid_sh)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-13)


def test_halo_step_2d_mesh(setup, eight_devices):
    p, f, fluid = setup
    mesh = sh.make_mesh(8, shape=(2, 4), axis_names=("y", "x"))

    def gstep(fa, fl):
        return sc.step(fa, fl, p)

    halo_step = sh.make_halo_step(gstep, mesh, width=2,
                                  state_leading=(1, 0), n_state=1)
    f_sh = sh.shard_lattice(f, mesh, leading=1)
    fluid_sh = sh.shard_lattice(fluid, mesh, leading=0)
    ref = sc.step(sc.step(f, fluid, p), fluid, p)
    out = halo_step(halo_step(f_sh, fluid_sh), fluid_sh)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-13)


def test_dryrun_multichip_runs_xla_halo_path(eight_devices, capsys):
    """The entry point's multi-device rehearsal (``__graft_entry__
    .dryrun_multichip``) runs the XLA halo-exchange step on virtual CPU
    devices, on a 1D and a 2D mesh, and matches the single-device step."""
    import __graft_entry__ as ge

    ge.dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "XLA halo path OK on mesh {'x': 4}" in out
    assert "XLA halo path OK on mesh {'y': 2, 'x': 2}" in out


def test_shard_state_cuts_divisible_trailing_axes(eight_devices):
    """The auto path's placement: the two trailing axes of rank ≥ 2
    arrays are cut where the mesh axis divides them; vectors, scalars
    and odd-sized fields are replicated."""
    from jax.sharding import PartitionSpec as P

    mesh = sh.make_mesh(4, shape=(2, 2), axis_names=("y", "x"))
    state = (jnp.zeros((9, 8, 12)), jnp.zeros((10, 7)), jnp.zeros(12),
             jnp.zeros(()))
    specs = [a.sharding.spec for a in sh.shard_state(state, mesh)]
    assert specs == [P(None, "y", "x"), P("y", None), P(None), P()]
