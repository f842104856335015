"""Profiling & throughput utilities (SURVEY §5.1 obligation).

The reference's only instrumentation is wall-clock + MLUPS (printMlups).
Here: the same MLUPS definition (io.loggers.MlupsClock), a
``jax.profiler`` trace context, and the one timing function every
benchmark uses.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/XProf."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def measure_mlups(fn, state, n_steps: int, nelem: int, reps: int = 3):
    """Throughput of ``fn`` (advances ``state`` by ``n_steps`` steps).

    One warm-up call (compiles), then ``reps`` timed calls, each ended by
    ``jax.block_until_ready``.  MLUPS = nelem · n_steps / seconds / 1e6,
    the reference's printMlups definition.  Returns a dict with the median
    ``mlups`` and ``ms_per_step``, ``spread = (max − min) / median`` over
    the reps, ``first_call_s`` (compile + one run) and the last output
    ``out``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(state))
    first = time.perf_counter() - t0
    dts = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(state))
        dts.append(time.perf_counter() - t0)
    dt = float(np.median(dts))
    return {"mlups": nelem * n_steps / dt / 1e6,
            "ms_per_step": dt * 1e3 / n_steps,
            "spread": float((max(dts) - min(dts)) / dt),
            "first_call_s": first, "out": out}
