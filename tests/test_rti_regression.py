"""CI gates for the RTI literature regression.

Two layers:

1. ``test_rti2048_trajectory_matches_literature`` — replay the archived
   trajectory (``validation/data/rti2048_trajectory.npz``, captured from
   a float32 2048×8200 run) through the exact notebook comparison
   (positions AND np.gradient+moving-average velocities) against the
   digitized He et al. 1999 curves.  Milliseconds; gates the comparison
   logic and the reference curves.
2. ``test_hcz_short_run_matches_golden`` — a 40-step N=64 HCZ
   Rayleigh-Taylor run vs a stored f64 snapshot, so ANY numerical change
   in models/hcz.py fails CI (the honest N=256-to-t=1 literature run is
   ~97 min on a CPU core and runs on the GPU instead:
   ``python -m multiphase_lbm_tpu.validation.rti_regression``).

Reference: ``Phase field model/Untitled.py`` cells 0-4 (the notebook),
``Phase field model/apps/rayleighTaylor2D.h:862-988`` (driver).
"""
import pathlib

import numpy as np

from multiphase_lbm_tpu.validation import captures
from multiphase_lbm_tpu.validation import rti_regression as rr

DATA = pathlib.Path(__file__).parent.parent / "multiphase_lbm_tpu" / \
    "validation" / "data"


def test_rti2048_trajectory_matches_literature():
    d = np.load(DATA / "rti2048_trajectory.npz")
    rc = rr.report(d["t"], d["s"], d["b"], t_end=float(d["t"][-1]),
                   N=2048)
    assert rc == 0


def test_hcz_short_run_matches_golden():
    for name, err, tol in captures.hcz_golden():
        assert err <= tol, (name, err, tol)
