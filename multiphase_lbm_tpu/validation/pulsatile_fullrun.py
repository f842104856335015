"""Full-archived-run statistical regression for the pulsatile vessel.

The reference ships a complete run of the severed compliant-vessel case
(103 ``sol_*.vtk`` dumps to t=2754 under ``Abbashub LBM/out_single-phase
fluid flow through a compliant vessel/`` — SURVEY §2.1 row 16).  Early
steps match bit-near-exactly (tests/test_pulsatile.py gates t=0 and
t=27 at output precision); over the full run the near-closed inlet
region is chaotic (staircase wall decisions amplify FP association
noise, models/pulsatile.py:28-30), so the whole-run comparison is
STATISTICAL:

* wall-position envelope: fluid extent per column from the Flag field;
* inlet pressure-wave amplitude and phase at a probe column;
* per-dump fluid-masked field statistics (mean/std of P, Ux).

Usage:  python -m multiphase_lbm_tpu.validation.pulsatile_fullrun [f32]
— float64 by default, ``f32`` for float32, on JAX's default device.
The pytest gate (tests/test_pulsatile_fullrun.py) runs the f64
comparison.

Reference: PulsatileBloodFlow2D.h:680-716 (saveVtkFields), :764-791
(step order; dump after the macro update of the same iteration).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

GOLD = Path("/root/reference/Abbashub LBM/"
            "out_single-phase fluid flow through a compliant vessel")
DUMP_EVERY = 27
N_DUMPS = 103
PROBE_X = 31          # inlet-region probe column (past the severed throat)


def _dump_indices(cadence):
    # dump 1 (t=27) is always included: it anchors the bit-near-exact
    # EARLY regime gate even at reduced cadence
    return sorted({0, 1} | set(range(0, N_DUMPS, cadence)))


def golden_metrics(cadence=1):
    """Parse every ``cadence``-th archived dump into the metric set."""
    from ..io import vtk

    out = []
    for i in _dump_indices(cadence):
        t = i * DUMP_EVERY
        g = vtk.read_vtk_fields(GOLD / f"sol_{t:07d}.vtk")
        fluid = g["Flag"].astype(int) == 0
        out.append(_metrics(g["P"], g["Ux"], fluid, t))
    return out


def _metrics(P, Ux, fluid, t):
    ny, nx = P.shape
    cols = fluid.sum(axis=0)                      # fluid extent per column
    rows = np.arange(ny)[:, None]
    lo = np.where(fluid, rows, ny).min(axis=0)    # first fluid row
    hi = np.where(fluid, rows, -1).max(axis=0)    # last fluid row
    m = fluid.sum() > 0
    Pm = P[fluid].mean() if m else 0.0
    Ps = P[fluid].std() if m else 0.0
    Um = Ux[fluid].mean() if m else 0.0
    Us = np.abs(Ux[fluid]).max() if m else 0.0
    pc = fluid[:, PROBE_X]
    P_probe = P[pc, PROBE_X].mean() if pc.any() else 0.0
    return dict(t=t, extent=cols, lo=lo, hi=hi, P_mean=Pm, P_std=Ps,
                Ux_mean=Um, Ux_absmax=Us, P_probe=P_probe)


def simulate_metrics(dtype="f64", cadence=1, progress=False):
    """Run the full 2765-step reference case and collect the same metrics
    at every ``cadence``-th dump instant."""
    import jax
    import jax.numpy as jnp

    from ..models import pulsatile as pm

    dt = jnp.float64 if dtype == "f64" else jnp.float32
    N = 64
    p = pm.PulsatileParams(nx=1 + 10 * (N - 2), ny=N)
    st = pm.initialize(p, dtype=dt)
    st = pm.step(st, 0, p)                       # dump 0 is after 1 step
    out = []
    keep = set(_dump_indices(cadence))
    run27 = jax.jit(lambda s, t: pm.run(s, t, p, DUMP_EVERY))
    for i in range(N_DUMPS):
        t = i * DUMP_EVERY
        if i:
            st = run27(st, 1 + (i - 1) * DUMP_EVERY)
        if i in keep:
            fluid = np.asarray(st.fluid)
            out.append(_metrics(np.asarray(st.P), np.asarray(st.Ux),
                                fluid, t))
            if progress and i % 20 == 0:
                print(f"  dump {i}/{N_DUMPS}", flush=True)
    return out


def compare(sim, gold):
    """Comparison table.  The run has three regimes (measured, f64):

    * EARLY (t ≤ 27): bit-near-exact — wall rows identical.  (The first
      staircase flip appears at t=54: max 2 rows; errors ramp through
      the transient, spiking to ~50 rows around t≈500.)
    * TRANSIENT (t ≈ 300–2400): chaotic — staircase wall decisions
      amplify ulp noise into transient wall-row differences (mean ≈ 1–2
      cells, spikes to ~50 during the violent relaxation at t≈500), while
      the pressure WAVE (the physical observable) stays in lock step
      (probe rms ~1e-5, amplitude to 4e-6, zero phase lag).
    * LATE (t ≥ ~2580): the orbits re-converge — wall rows agree exactly
      again at the final dumps (the severed outlet drains the vessel into
      a quiescent state both trajectories share).

    Gates therefore split by regime; the wave metrics gate the whole run.
    """
    assert len(sim) == len(gold)

    def wall_err(s, g):
        # Sentinels (all-solid column): lo = ny, hi = -1.  A column solid
        # in BOTH trajectories contributes 0; one solid in only ONE
        # contributes an O(ny) error — deliberately: it IS a wall
        # disagreement the late-regime gate must see.
        return np.maximum(np.abs(s["lo"] - g["lo"]),
                          np.abs(s["hi"] - g["hi"])).astype(float)

    n = len(sim)
    early = [i for i in range(n) if sim[i]["t"] <= 27]
    late = [i for i in range(n) if sim[i]["t"] >= 2580]
    wall_all = np.concatenate([wall_err(sim[i], gold[i])
                               for i in range(n)])
    wall_early = np.concatenate([wall_err(sim[i], gold[i])
                                 for i in early]) if early else wall_all
    wall_late = np.concatenate([wall_err(sim[i], gold[i])
                                for i in late]) if late else wall_all
    dP_late = max(abs(sim[i]["P_mean"] - gold[i]["P_mean"])
                  for i in late) if late else 0.0
    dUx_late = max(abs(sim[i]["Ux_absmax"] - gold[i]["Ux_absmax"])
                   for i in late) if late else 0.0

    Pp_sim = np.array([s["P_probe"] for s in sim])
    Pp_gold = np.array([g["P_probe"] for g in gold])
    # oscillatory tail (Pin waveform active after t_start ≈ 2144)
    k0 = next((i for i in range(n) if sim[i]["t"] >= 2144), n - 4)
    amp_s = Pp_sim[k0:].max() - Pp_sim[k0:].min()
    amp_g = Pp_gold[k0:].max() - Pp_gold[k0:].min()
    a = Pp_sim[k0:] - Pp_sim[k0:].mean()
    b = Pp_gold[k0:] - Pp_gold[k0:].mean()
    lags = range(-3, 4)
    cc = [np.correlate(np.roll(a, l), b)[0] for l in lags]
    lag = list(lags)[int(np.argmax(cc))]
    rms_tail = float(np.sqrt(((Pp_sim[k0:] - Pp_gold[k0:]) ** 2).mean()))
    return {
        "probe_rms_tail": rms_tail,
        "wall_early_max_err": float(wall_early.max()),
        "wall_late_max_err": float(wall_late.max()),
        "wall_global_mean_err": float(wall_all.mean()),
        "P_mean_late_err": float(dP_late),
        "Ux_absmax_late_err": float(dUx_late),
        "wave_amp_rel_err": float(abs(amp_s - amp_g)
                                  / max(abs(amp_g), 1e-12)),
        "wave_phase_lag_dumps": int(lag),
        "probe_rms": float(np.sqrt(((Pp_sim - Pp_gold) ** 2).mean())),
    }


# stated tolerances (~2× the measured f64 deviations; chaotic mid-run ⇒
# statistical gating, see compare())
GATES = {
    "wall_early_max_err": 1.0,       # cells — bit-near-exact regime
    "wall_late_max_err": 2.0,        # cells — re-converged regime
    "wall_global_mean_err": 3.0,     # cells incl. the chaotic transient
    "P_mean_late_err": 1e-3,         # pressure LU (p_osc = 2e-3)
    "Ux_absmax_late_err": 2e-3,
    "wave_amp_rel_err": 0.1,
    "probe_rms": 3e-4,
}

# float32 runs: the staircase
# chaos starts at the FIRST wall update (no bit-exact early regime to
# gate) and the late orbits re-converge only to within a few cells, so
# the f32 gates drop the early gate, loosen the wall envelopes, and
# anchor on the physical observables: the inlet pressure wave in the
# oscillatory tail (amplitude/phase/tail-rms) and the late field values.
GATES_F32 = {
    "wall_late_max_err": 4.0,
    "wall_global_mean_err": 3.0,
    "P_mean_late_err": 1e-3,
    "Ux_absmax_late_err": 2e-3,
    "wave_amp_rel_err": 0.1,
    "probe_rms_tail": 1e-3,
}

def check(table, gates=GATES):
    ok = True
    for k, tol in gates.items():
        v = table[k]
        good = v <= tol
        ok &= good
        print(f"  {k}: {v:.5g} (tol {tol}) {'PASS' if good else 'FAIL'}")
    lag_ok = abs(table["wave_phase_lag_dumps"]) <= 1
    print(f"  wave_phase_lag_dumps: {table['wave_phase_lag_dumps']}"
          f" (tol ±1) {'PASS' if lag_ok else 'FAIL'}")
    return ok and lag_ok


def main():
    from ..utils.runtime import configure_compile_cache, enable_x64_for

    configure_compile_cache()
    dtype = "f32" if "f32" in sys.argv[1:] else "f64"
    if dtype == "f64":
        enable_x64_for(np.float64)
    cadence = 1
    print(f"simulating full reference run ({dtype})…", flush=True)
    sim = simulate_metrics(dtype=dtype, cadence=cadence, progress=True)
    gold = golden_metrics(cadence=cadence)
    table = compare(sim, gold)
    ok = check(table, GATES if dtype == "f64" else GATES_F32)
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
