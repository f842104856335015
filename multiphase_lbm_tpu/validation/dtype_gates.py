"""float32 against float64, per model family.

The same configuration is run in both dtypes from the same initial state
and the family's observable (``models.registry``) is compared as
``max |o32 − o64| / max |o64|``.  ``GATES`` holds that error as measured
on the CPU (XLA CPU backend, every contraction at HIGHEST precision) at
a small lattice; a run anywhere else — the GPU at the benchmark shapes —
passes when its error is at most ``FACTOR`` times it.  A float32 product
run in TF32 (about three decimal digits) misses by orders of magnitude.

The pulsatile comparison runs the rigid-wall vessel: with deformable
walls the staircase wall decisions are chaotic, and float32 and float64
wall positions part from 1e-6 to several cells within 50 steps (measured
on the CPU), so no pointwise tolerance exists there.
"""
from __future__ import annotations

import numpy as np

# family -> (CPU lattice shape, steps, CPU-measured f32-vs-f64 error)
GATES = {
    "sc": ((512, 512), 200, 1.308e-5),
    "scrt": ((514, 128), 200, 3.041e-4),
    "hcz": ((258, 64), 50, 8.329e-7),
    "hcz3d": ((48, 48, 48), 50, 1.881e-6),
    "fakhari": ((128, 128), 90, 1.998e-5),
    "combustion": ((80, 420), 200, 2.234e-6),
    "pulsatile": ((64, 621), 200, 3.531e-5),
}
FACTOR = 2.0
# family -> registry options of the compared configuration
OPTIONS = {"pulsatile": {"deformable": False}}


def f32_f64_error(family, shape, steps) -> float:
    """Relative max error of the float32 run against the float64 run.
    Needs ``jax_enable_x64``."""
    import jax.numpy as jnp

    from ..models import registry

    obs = {}
    for dtype in (jnp.float32, jnp.float64):
        sim = registry.build(family, shape, dtype, **OPTIONS.get(family, {}))
        out = sim.observable(sim.run(sim.state, steps))
        if out.dtype != dtype:
            raise TypeError(f"{family}: {np.dtype(dtype).name} run "
                            f"returned {out.dtype}")
        obs[dtype] = np.asarray(out, dtype=np.float64)
    a, b = obs[jnp.float32], obs[jnp.float64]
    return float(np.abs(a - b).max() / np.abs(b).max())


def tolerance(family) -> float:
    return FACTOR * GATES[family][2]
