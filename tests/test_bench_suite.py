"""CPU gates for the benchmark suite harness (runners/bench_suite).

Each workload builds at its quick size and takes one XLA step: this checks
the registry → build → step plumbing, not the numbers, which are measured
on the GPU only (the suite refuses to time anything on the CPU).
"""
import jax
import numpy as np
import pytest

from multiphase_lbm_tpu.runners import bench_suite


@pytest.mark.parametrize("name", sorted(bench_suite.WORKLOADS))
def test_quick_workload_runs(name):
    sim = bench_suite.WORKLOADS[name].build(quick=True)
    out = sim.run(sim.state, 1)
    before = jax.tree_util.tree_leaves(sim.state)
    after = jax.tree_util.tree_leaves(out)
    assert [a.shape for a in after] == [a.shape for a in before]
    assert [a.dtype for a in after] == [a.dtype for a in before]
    assert after[0].dtype == np.float32
    assert np.isfinite(np.asarray(after[0])).all()


def test_registry_builds_quick_configs():
    assert set(bench_suite.WORKLOADS) == {
        "sc", "hcz", "hcz2048", "hcz3d", "fakhari", "scrt", "combustion",
        "combustion840", "pulsatile"}
    for name, wl in bench_suite.WORKLOADS.items():
        sim = wl.build(quick=True)
        lattice = jax.tree_util.tree_leaves(sim.state)[0]
        assert lattice.shape[1:] == wl.quick_shape, name
        assert wl.steps > 0


def test_suite_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit, match="no GPU"):
        bench_suite.main(["sc"])
    assert capsys.readouterr().out == ""


def test_check_finite_rejects_nan():
    import jax.numpy as jnp

    sim = bench_suite.WORKLOADS["sc"].build(quick=True)
    bench_suite.check_finite(sim, sim.state, "sc")
    with pytest.raises(FloatingPointError, match="sc: non-finite"):
        bench_suite.check_finite(sim, sim.state.at[0, 0, 0].set(jnp.nan),
                                 "sc")
