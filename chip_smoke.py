#!/usr/bin/env python
"""On-card smoke test: every model family's XLA step on an NVIDIA GPU.

    python chip_smoke.py            # phases a-d, one GPU
    python chip_smoke.py --multi    # phase e only, four GPUs

Phases, each printed as one line with wall time, compile time, MLUPS,
``peak_bytes_in_use`` (process peak so far) and its error beside its
tolerance:

a. the CLI (``runners.coolbm``) at its default float64 on the reference
   configurations: the Laplace droplet's whole run, the pulsatile vessel's
   2765-step run with its 103 VTK dumps (plus the final state),
   combustion ``--bench`` in f64 and ``--f32``, and 3200 steps of the HCZ
   Rayleigh–Taylor case; every run's ``sol_*.vtk`` and ``.dat`` files
   must exist and be finite;
b. the headline, SC-MRT 2048² in float32 for 200 steps, against the same
   run in float64 (``validation.dtype_gates``);
c. every other benchmark workload (``runners.bench_suite``) at its
   shape, float32 against float64 the same way;
d. the C++ and golden captures in float64 (``validation.captures``);
e. SC-MRT 8192² float32 through ``parallel.sharding.make_halo_step`` on a
   1D mesh of 4 and a 2×2 mesh, against the same lattice on one card.

Any failure raises and exits nonzero.  The line before the last holds the
card's name and power limit from ``nvidia-smi``; the last line is one JSON
object ``{"ok": true, "device": {...}}``.  Without a GPU it exits nonzero
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# compile seconds reported by JAX, summed over every compilation
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]


def _on_event(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration


class Phase:
    """Times one phase: wall clock and the compile seconds inside it."""

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        self.c0, self.t0 = _compile_s[0], time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall_s = time.perf_counter() - self.t0
        self.compile_s = _compile_s[0] - self.c0


def report(ph, err, tol, mlups=None):
    """Print the phase line; raise if ``err`` is above ``tol``."""
    from multiphase_lbm_tpu.utils.runtime import peak_bytes

    ok = err <= tol
    mlups_s = "not measured" if mlups is None else f"{mlups:.1f}"
    print(f"phase {ph.label}: wall_s={ph.wall_s:.2f} "
          f"compile_s={ph.compile_s:.2f} mlups={mlups_s} "
          f"peak_bytes_in_use={peak_bytes()} err={err:.3e} tol={tol:.3e} "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"phase {ph.label}: error {err:.3e} > "
                             f"tolerance {tol:.3e}")


# ─── a: the CLI ─────────────────────────────────────────────────────────────
def _nonfinite_in_outputs(outdir, need_dat=True):
    """Count non-finite values in the last VTK dump and every .dat file;
    raise if an expected file is missing."""
    import numpy as np

    from multiphase_lbm_tpu.io.vtk import read_vtk_fields

    vtks = sorted(f for f in os.listdir(outdir) if f.startswith("sol_"))
    dats = sorted(f for f in os.listdir(outdir) if f.endswith(".dat"))
    if not vtks or (need_dat and not dats):
        raise FileNotFoundError(f"{outdir}: sol_*.vtk {vtks[-1:]} "
                                f"/ .dat {dats} missing")
    bad = 0
    for name, v in read_vtk_fields(os.path.join(outdir, vtks[-1])).items():
        if name != "DIMENSIONS":
            bad += int((~np.isfinite(v)).sum())
    for d in dats:
        bad += int((~np.isfinite(np.loadtxt(os.path.join(outdir, d),
                                             ndmin=1))).sum())
    return bad, len(vtks)


def _cli(argv):
    """Run ``coolbm.main(argv)``; return the MLUPS it printed."""
    from multiphase_lbm_tpu.runners import coolbm

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = coolbm.main(argv)
    if rc != 0:
        raise RuntimeError(f"coolbm {argv} returned {rc}")
    m = re.findall(r"(?:Throughput|MLUPS):\s*([-+0-9.eE]+|nan|inf)",
                   buf.getvalue())
    return float(m[-1]) if m else None


def phase_a(workdir=None):
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            return phase_a(work)
    # (problem, extra arguments, writes .dat logs)
    runs = [
        ("laplace2D_sc", [], True),
        ("PulsatileBloodFlow2D", [], False),
        ("rayleighTaylor2D", ["--steps", "3200"], True),
    ]
    for label, extra, need_dat in runs:
        outdir = os.path.join(workdir, label)
        with Phase(f"a {label} f64") as ph:
            mlups = _cli([label, *extra, "--outdir", outdir])
        bad, n_vtk = _nonfinite_in_outputs(outdir, need_dat)
        # the reference cadence (tf/100: t = 0, 27, …, 2754) is 103 dumps;
        # the runner adds the final state
        if label == "PulsatileBloodFlow2D" and n_vtk != 104:
            raise AssertionError(f"pulsatile wrote {n_vtk} VTK dumps, not "
                                 "103 + the final one")
        report(ph, bad, 0, mlups)
    for extra, tag in (([], "f64"), (["--f32"], "f32")):
        outdir = os.path.join(workdir, f"combustion_{tag}")
        with Phase(f"a combustion --bench {tag}") as ph:
            mlups = _cli(["combustion", "--bench", "--outdir", outdir]
                         + extra)
        report(ph, 0 if mlups is not None and math.isfinite(mlups) else 1, 0,
               mlups)


# ─── b, c: float32 against float64 at the benchmark shapes ─────────────────
def _dtype_phase(label, family, shape, steps):
    import jax.numpy as jnp

    from multiphase_lbm_tpu.models import registry
    from multiphase_lbm_tpu.runners.bench_suite import check_finite
    from multiphase_lbm_tpu.utils.profiling import measure_mlups
    from multiphase_lbm_tpu.validation import dtype_gates as dg

    with Phase(label) as ph:
        # the timed run is the benchmark configuration, in float32
        sim = registry.build(family, shape, jnp.float32)
        m = measure_mlups(lambda s: sim.run(s, steps), sim.state, steps,
                          math.prod(shape))
        check_finite(sim, m["out"], label)
        mlups = m["mlups"]
        del sim, m
        err = dg.f32_f64_error(family, shape, steps)
    report(ph, err, dg.tolerance(family), mlups)


def phase_b():
    _dtype_phase("b sc 2048x2048 f32 vs f64", "sc", (2048, 2048), 200)


def phase_c():
    from multiphase_lbm_tpu.runners import bench_suite
    from multiphase_lbm_tpu.validation import dtype_gates as dg

    for name, wl in bench_suite.WORKLOADS.items():
        if name != "sc":                 # sc at 2048² is phase b
            _dtype_phase(f"c {name} {'x'.join(map(str, wl.shape[::-1]))} "
                         "f32 vs f64", wl.family, wl.shape,
                         dg.GATES[wl.family][1])


# ─── d: C++ and golden captures, float64 ───────────────────────────────────
def phase_d():
    from multiphase_lbm_tpu.validation import captures

    for label, fn in (("combustion 128x48 vs C++", captures.combustion_parity),
                      ("SC-RT 250 steps vs C++", captures.scrt_parity),
                      ("HCZ N=64 40 steps vs golden", captures.hcz_golden)):
        with Phase(f"d {label} f64") as ph:
            rows = fn()
        worst = max(rows, key=lambda r: r[1] / r[2])
        print(f"  {label}: " + ", ".join(f"{n}={e:.3e}/{t:.0e}"
                                         for n, e, t in rows), flush=True)
        report(ph, worst[1] / worst[2], 1.0)


# ─── e: four cards ─────────────────────────────────────────────────────────
def phase_e(n=8192, steps=20):
    """SC-MRT ``n``² float32: ``make_halo_step`` on a 1D mesh of 4 and a
    2×2 mesh against the same lattice stepped on one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from multiphase_lbm_tpu.models import shan_chen as sc
    from multiphase_lbm_tpu.parallel import sharding as sh
    from multiphase_lbm_tpu.utils.profiling import measure_mlups

    devs = np.array(jax.devices()[:4])
    if devs.size < 4:
        raise RuntimeError(f"--multi needs 4 devices, found {devs.size}")
    p = sc.SCParams(collision="mrt")
    fl = sc.geometry_periodic(n, n)
    f0 = sc.init_droplet(n, n, p, radius=n / 8.0, dtype=jnp.float32)
    with Phase(f"e sc {n}x{n} f32 one device") as ph:
        m = measure_mlups(lambda f: sc.run(f, fl, p, steps), f0, steps, n * n)
        ref = np.asarray(sc.density(m.pop("out")))
    report(ph, 0.0, 0.0, m["mlups"])
    scale = np.abs(ref).max()
    for shape, names in (((4,), ("x",)), ((2, 2), ("y", "x"))):
        mesh = Mesh(devs.reshape(shape), names)
        halo_step = sh.make_halo_step(lambda f, m_: sc.step(f, m_, p), mesh,
                                      width=2, state_leading=(1, 0))
        f_sh = sh.shard_lattice(f0, mesh, leading=1)
        fl_sh = sh.shard_lattice(fl, mesh, leading=0)

        def run_sharded(f):
            for _ in range(steps):
                f = halo_step(f, fl_sh)
            return f

        with Phase(f"e sc {n}x{n} f32 halo mesh {dict(mesh.shape)}") as ph:
            m = measure_mlups(run_sharded, f_sh, steps, n * n)
            rho = np.asarray(sc.density(m.pop("out")))
        report(ph, float(np.abs(rho - ref).max() / scale), 1e-5, m["mlups"])


# ─── main ──────────────────────────────────────────────────────────────────
def phases(multi: bool):
    """The phases a run executes, in order."""
    return [phase_e] if multi else [phase_a, phase_b, phase_c, phase_d]


def last_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def main(argv=None):
    ap = argparse.ArgumentParser(prog="chip_smoke")
    ap.add_argument("--multi", action="store_true",
                    help="run only phase e, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from multiphase_lbm_tpu.utils.runtime import (
        card_line, configure_compile_cache, device_record, enable_x64_for,
        require_gpu)

    configure_compile_cache()
    require_gpu()
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    # phases a and d compute in float64, phases b, c pass dtypes explicitly
    enable_x64_for("float64")
    device = device_record()
    print(f"device: {json.dumps(device)}", flush=True)
    for phase in phases(args.multi):
        phase()
    print(card_line(), flush=True)
    print(last_line(device_record()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
