"""Benchmark suite: the reference's roadmap item it never built.

The reference README lists "Automated regression tests and benchmarking
suite" as future work (reference README.md:142) and only prints MLUPS at
the end of each run (SURVEY §6).  This module times each model family's
jitted XLA step (``models/*.run``) at its benchmark shape on one GPU and
prints one JSON line per workload:

    python -m multiphase_lbm_tpu.runners.bench_suite            # all
    python -m multiphase_lbm_tpu.runners.bench_suite sc hcz3d   # subset

MLUPS definition identical to the reference's printMlups (nelem·iters/µs,
e.g. ``Abbashub LBM/apps/PulsatileBloodFlow2D.h:708-716``); timing is
``utils.profiling.measure_mlups`` (warm-up, then the median of the reps,
each ended by ``jax.block_until_ready``).  Every record names the device
and the card's power limit.  Without a GPU the suite refuses to run.
``vs_cpp_core`` is the speedup over the C++ reference measured on one
CPU core (BASELINE.md table); ``None`` where no reference config exists.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import NamedTuple


class Workload(NamedTuple):
    family: str        # models.registry family
    shape: tuple       # benchmark lattice shape
    quick_shape: tuple  # tiny lattice of the same configuration (CPU tests)
    steps: int         # timed window
    cpp_core_mlups: float | None   # C++ reference on one CPU core
    desc: str

    def build(self, quick=False, dtype=None):
        import jax.numpy as jnp

        from ..models import registry
        return registry.build(self.family,
                              self.quick_shape if quick else self.shape,
                              dtype or jnp.float32)


# The shapes are those the suite has always timed (BASELINE.md rows);
# C++ per-core MLUPS from the BASELINE.md table.
WORKLOADS = {
    "sc": Workload("sc", (2048, 2048), (32, 32), 200, None,
                   "SC-MRT droplet, periodic"),
    "hcz": Workload("hcz", (1024, 256), (66, 16), 200, 0.383, "HCZ RTI"),
    "hcz2048": Workload("hcz", (8200, 2048), (66, 16), 50, 0.383,
                        "HCZ RTI-2048"),
    "hcz3d": Workload("hcz3d", (128, 128, 128), (8, 8, 8), 50, None,
                      "HCZ D3Q19 droplet"),
    "fakhari": Workload("fakhari", (1024, 1024), (32, 32), 90, 4.96,
                        "Fakhari Young-Laplace bubble"),
    "scrt": Workload("scrt", (2050, 512), (66, 16), 200, 0.35, "SC-RT"),
    "combustion": Workload("combustion", (80, 420), (16, 48), 500, 0.346,
                           "reactive combustion, 4 populations"),
    "combustion840": Workload("combustion", (160, 840), (16, 48), 500,
                              0.346, "reactive combustion, 4 populations"),
    "pulsatile": Workload("pulsatile", (64, 621), (16, 141), 1000, 0.454,
                          "deformable vessel"),
}


def check_finite(sim, out, label):
    """Raise unless the populations and the observable of ``out`` are
    finite: a fast number computed on NaNs is not a benchmark.  (Other
    state arrays may hold NaN in solid cells, e.g. combustion's previous
    forcing terms, which the step masks out.)"""
    import jax
    import jax.numpy as jnp

    for a in (jax.tree_util.tree_leaves(out)[0], sim.observable(out)):
        if not bool(jnp.isfinite(a).all()):
            raise FloatingPointError(f"{label}: non-finite state")


def run_workload(name, reps=3) -> dict:
    """Time one workload's XLA step (see :func:`check_finite`)."""
    from ..utils.profiling import measure_mlups
    from ..utils.runtime import peak_bytes

    wl = WORKLOADS[name]
    sim = wl.build()
    cells = math.prod(wl.shape)
    m = measure_mlups(lambda s: sim.run(s, wl.steps), sim.state, wl.steps,
                      cells, reps=reps)
    check_finite(sim, m["out"], name)
    ref = wl.cpp_core_mlups
    return {"workload": name,
            "config": f"{'x'.join(map(str, wl.shape[::-1]))} {wl.desc} f32",
            "steps": wl.steps, "mlups": m["mlups"],
            "ms_per_step": m["ms_per_step"], "spread": m["spread"],
            "first_call_s": m["first_call_s"],
            "peak_bytes_in_use": peak_bytes(),
            "vs_cpp_core": m["mlups"] / ref if ref else None}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_suite")
    ap.add_argument("workloads", nargs="*", default=[],
                    help=f"subset of {list(WORKLOADS)} (default: all)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions; the JSON reports the median "
                         "and the (max-min)/median spread")
    args = ap.parse_args(argv)

    from ..utils.runtime import (card_line, configure_compile_cache,
                                 device_record, require_gpu)

    configure_compile_cache()
    require_gpu()
    device = {**device_record(), "card": card_line()}
    print(json.dumps({"device": device}), flush=True)
    for name in args.workloads or list(WORKLOADS):
        rec = run_workload(name, reps=args.reps)
        print(json.dumps({**rec, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
