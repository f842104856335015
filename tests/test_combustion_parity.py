"""CI gate: field parity of the combustion model against an instrumented
run of the reference C++.

Capture protocol (BASELINE.md): copy ``CooLBM_MRT_combustion.cpp`` to a
scratch dir; patch ONLY N_X/N_Y→128/48 (globals AND main's locals — the
global grid sizes dimension the file-scope side arrays), Einleseoption_f
→false (cold start; global :247 and the runCavityTwoPop local :4274),
vtk_freq→100, max_time_iter→520; build ``g++ -O3 -march=native -std=c++17
-ltbb``; parse the ``sol_*.vtk`` dumps (Density/Temperature/Y_O2/Y_CO2/
velocity_X/velocity_Y/Flag) into
``validation/data/combustion_reference.npz``.

The shipped binary's actual behavior (what the capture contains):

* ``Konv`` is true from step 0 — the run-loop convergence gate mutates a
  local shadowing the file-scope flag the functor reads
  (:254 vs :4281, :4394-4412), so all four populations are active from
  the first iteration and the gate logic never fires;
* the file-scope ``first_step`` is never cleared (:71 vs the shadowing
  locals :4099/:4463), so the ``LI2014 &! first_step`` conjugate-BC
  branch (:3105) is dead code in the binary — hence
  ``make_step(first_step=True)`` here (binary-faithful mode; ``run()``
  keeps the paper-intended LI2014 behavior as the default).

Gate: every VTK field at steps 100..500 matches at float-output
precision (the reference prints %g ≈ 6 significant digits) over all
bulk cells, and Temperature additionally over the solid obstacle.
"""
from multiphase_lbm_tpu.validation import captures


def test_combustion_matches_cpp_reference_500_steps():
    for label, err, tol in captures.combustion_parity():
        assert err < tol, (label, err, tol)
