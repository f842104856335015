"""Per-family invariants of the XLA step, one case per model family.

* ``run(n)`` equals ``run(k)`` then ``run(n − k)``, and equals ``n``
  calls of ``step``, in float64: the jitted time loop is the step, and a
  run can be chunked at any output cadence.
* Every ``dot_general`` in the step's jaxpr runs at HIGHEST precision, so
  an unpinned product (TF32 on the GPU) fails here, on the CPU, where it
  would not show numerically.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multiphase_lbm_tpu.models import registry

SHAPES = {
    "sc": (16, 16), "scrt": (66, 16), "hcz": (66, 16), "hcz3d": (8, 8, 8),
    "fakhari": (16, 16), "combustion": (16, 48), "pulsatile": (16, 141),
}


def _close(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("family", sorted(registry.FAMILIES))
def test_run_chunks_and_steps_agree(family):
    assert sorted(SHAPES) == sorted(registry.FAMILIES)
    sim = registry.build(family, SHAPES[family], jnp.float64)
    n, k = 4, 1
    whole = sim.run(sim.state, n)
    chunked = sim.run(sim.run(sim.state, k), n - k, t0=k)
    step = jax.jit(sim.step)
    stepped = sim.state
    for t in range(n):
        stepped = step(stepped, t)
    assert jax.tree_util.tree_leaves(whole)[0].dtype == np.float64
    _close(chunked, whole)
    _close(stepped, whole)


def _dot_precisions(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    _dot_precisions(inner, out)
    return out


@pytest.mark.parametrize("family", sorted(registry.FAMILIES))
def test_step_contractions_pin_highest_precision(family):
    sim = registry.build(family, SHAPES[family], jnp.float32)
    jaxpr = jax.make_jaxpr(lambda s: sim.step(s, 0))(sim.state)
    precisions = _dot_precisions(jaxpr.jaxpr, [])
    assert precisions, f"{family}: no contraction found in the step"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), (family, precisions)
