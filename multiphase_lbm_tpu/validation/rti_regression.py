"""RTI literature regression: run the HCZ Rayleigh-Taylor case and compare
spike/bubble trajectories against the digitized published curves the
reference validates with (SURVEY §4.3, notebook cells 0-4: both the 256²
and the 2048² runs).

Usage (on the GPU):

    python -m multiphase_lbm_tpu.validation.rti_regression [t_end] [N]

N=256 (default) and N=2048 (2048×8200 lattice) both run the model's
jitted XLA step in float32.  The archived N=2048 trajectory
(``validation/data/rti2048_trajectory.npz``, keys t, s, b; t_end=3)
passes the gates below (max |spike − literature| = 0.0611, |bubble| =
0.0253, tolerance 0.15; velocity curves, notebook cells 2-3: np.gradient
+ 7-sample moving average, 0.0794 / 0.0286, tolerance 0.25) and is
replayed against the curves in CI (tests/test_rti_regression.py).
``--archive`` refreshes it from a passing N ≥ 1024 run.
"""
from __future__ import annotations

import sys

import numpy as np

from ..io.config import lb_parameters
from ..models import hcz
from . import rti_reference as ref


def run_regression(t_end=2.0, N=256, dtype=None, log_every=0.05):
    import jax.numpy as jnp

    dtype = dtype or jnp.float32
    # The notebook's out_256/out_2048 folders are *Reynolds numbers* (plot
    # titles "Re = 256" / "Re = 2048", curves digitized from He et al. 1999).
    # The shipped config (config_rayleighTaylor2D.txt) runs Re=3000 at N=256
    # and its output tracks the Re-256 curves to the regression tolerance, so
    # the 256 case keeps the config value; the 2048 case uses the literature
    # Re it is compared against.
    Re = 2048.0 if N >= 1024 else 3000.0
    ulb = 0.04
    nu, omega, dx, dt = lb_parameters(ulb, N, Re)
    # Dimensionless gravity g* = g_lu·N/ulb² is exactly 1 for the reference
    # config (6.25e-6·256/0.04² = 1, rayleighTaylor2D.h:56-62 scaling with
    # dt = dx·ulb), so the LU gravity must scale as 1/N to stay the same
    # physical problem at higher resolution.
    p = hcz.HCZParams(omega=omega, gravity=-ulb * ulb / N, kappa=0.01)
    ny = 4 * N + 2
    state = hcz.init_rayleigh_taylor(N, ny, p, dtype=dtype)
    fluid = hcz.geometry_channel(N, ny)
    state = hcz.apply_geometry(state, fluid)

    chunk = max(1, int(round(log_every / dt)))
    times, spikes, bubbles = [], [], []
    it = 0
    steps_total = int(t_end / dt)
    phi_mid = 0.5 * (p.phi_l + p.phi_g)

    def heights(f):
        # pull only the two probe columns (x=0 'bubble', x=nx/2 'spike'),
        # not the whole φ field (67 MB at N=2048)
        cols = np.asarray(jnp.sum(f[:, :, :: max(1, N // 2)][:, :, :2],
                                  axis=0))
        out = []
        for j in (1, 0):                      # spike = x=nx/2, bubble = x=0
            col = cols[1:ny - 1, j]
            below = np.nonzero(col <= phi_mid)[0]
            out.append(int(below[-1]) + 1 if below.size else 0)
        return out

    while it < steps_total:
        state = hcz.run(state, fluid, p, chunk)
        it += chunk
        s, b = heights(state[0])
        times.append(it * dt)
        spikes.append(s * dx - 2.0)     # shift by the initial interface
        bubbles.append(b * dx - 2.0)
    return np.array(times), np.array(spikes), np.array(bubbles)


def compare(times, heights, ref_t, ref_y):
    """Max |sim − published| over the overlapping time range."""
    ref_t = np.asarray(ref_t)
    ref_y = np.asarray(ref_y)
    lo, hi = max(times.min(), ref_t.min()), min(times.max(), ref_t.max())
    mask = (ref_t >= lo) & (ref_t <= hi)
    interp = np.interp(ref_t[mask], times, heights)
    return float(np.abs(interp - ref_y[mask]).max())


def moving_average(data, window_size=7):
    """The notebook's velocity smoother (Untitled.py cell 3)."""
    return np.convolve(data, np.ones(window_size) / window_size,
                       mode="same")


def compare_velocity(times, heights, ref_t, ref_y, window=7):
    """Velocity comparison exactly as the notebook does it (cells 2-3):
    finite-difference both trajectories with np.gradient, smooth the
    simulated one with a 7-sample moving average, compare on the
    overlapping range.  Endpoint samples (half-filled smoothing window)
    are excluded."""
    ref_t = np.asarray(ref_t)
    ref_y = np.asarray(ref_y)
    v_sim = moving_average(np.gradient(heights, times), window)
    v_ref = np.gradient(ref_y, ref_t)
    pad = window * (times[1] - times[0])
    lo = max(times.min() + pad, ref_t.min())
    hi = min(times.max() - pad, ref_t.max())
    mask = (ref_t >= lo) & (ref_t <= hi)
    interp = np.interp(ref_t[mask], times, v_sim)
    return float(np.abs(interp - v_ref[mask]).max())


def archive_path():
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "rti2048_trajectory.npz")


def main(argv=None):
    from ..utils.runtime import configure_compile_cache

    configure_compile_cache()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = [a for a in argv if a != "--archive"]
    do_archive = "--archive" in argv
    t_end = float(args[0]) if len(args) > 0 else 2.0
    N = int(args[1]) if len(args) > 1 else 256
    times, spikes, bubbles = run_regression(t_end=t_end, N=N)
    rc = report(times, spikes, bubbles, t_end, N)
    if do_archive:
        if N >= 1024 and rc == 0:
            # refresh the CI replay artifact with the current step's
            # trajectory (only on PASS — a failing trajectory must not
            # become the archived baseline)
            np.savez(archive_path(), t=times, s=spikes, b=bubbles)
            print(f"archived -> {archive_path()}")
        else:
            # visible skip: silence here would read as "artifact refreshed"
            print(f"archive SKIPPED ({'N < 1024' if N < 1024 else 'FAIL'}) "
                  f"— {archive_path()} unchanged")
    return rc


def report(times, spikes, bubbles, t_end, N):
    if N >= 1024:
        rs_t, rs_y = ref.x_spike_2048, ref.y_spike_2048
        rb_t, rb_y = ref.x_bubble_2048, ref.y_bubble_2048
    else:
        rs_t, rs_y = ref.x_spike_256, ref.y_spike_256
        rb_t, rb_y = ref.x_bubble_256, ref.y_bubble_256
    ds = compare(times, spikes, rs_t, rs_y)
    db = compare(times, bubbles, rb_t, rb_y)
    dvs = compare_velocity(times, spikes, rs_t, rs_y)
    dvb = compare_velocity(times, bubbles, rb_t, rb_y)
    print(f"t_end={t_end} N={N}")
    print(f"max |spike - literature|  = {ds:.4f} (domain heights)")
    print(f"max |bubble - literature| = {db:.4f}")
    print(f"max |spike velocity  - literature| = {dvs:.4f} (heights/time)")
    print(f"max |bubble velocity - literature| = {dvb:.4f}")
    # velocities are finite differences of digitized curves: the reference
    # curve's own sampling noise is ~0.05-0.1, so the gate is looser
    ok = ds < 0.15 and db < 0.15 and dvs < 0.25 and dvb < 0.25
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
