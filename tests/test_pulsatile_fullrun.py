"""Full-archived-run statistical regression for the pulsatile vessel.

Consumes the complete 103-dump golden artifact of the reference run
(`/root/reference/Abbashub LBM/out_single-phase fluid flow through a
compliant vessel/` — SURVEY §2.1 row 16) at reduced metric cadence and
gates the regime-split comparison of validation/pulsatile_fullrun.py:
wall-position envelope, inlet pressure-wave amplitude/phase, and
fluid-masked field statistics.  CPU f64; the f32 run of the same
comparison is ``python -m multiphase_lbm_tpu.validation.pulsatile_fullrun
f32``.

Reference: PulsatileBloodFlow2D.h:680-716 (dump schema), :764-791
(step order).  This is the heaviest test in the suite (~2.5 min: the
full 2765-step reference case); cadence=3 trims only the golden VTK
parsing, not the simulated trajectory.
"""
import pytest

from multiphase_lbm_tpu.validation import pulsatile_fullrun as fr


@pytest.mark.slow
def test_full_archived_run_statistics():
    cadence = 3
    sim = fr.simulate_metrics(dtype="f64", cadence=cadence)
    gold = fr.golden_metrics(cadence=cadence)
    table = fr.compare(sim, gold)
    for k, tol in fr.GATES.items():
        assert table[k] <= tol, (k, table[k], tol)
    assert abs(table["wave_phase_lag_dumps"]) <= 1, table

