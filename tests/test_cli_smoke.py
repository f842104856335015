"""CLI smoke tests: every problem wired in runners/coolbm.py runs
end-to-end (config parse → driver → model step → VTK/.dat output) at a
tiny lattice for 2 steps, in float64 (the default) and with ``--f32``.

Catches wiring regressions in the 500-line runners/apps.py surface that
the model-level tests can't see (argument plumbing, config key reads,
output-file naming).  The combustion problem has its own deeper CLI
tests (tests/test_combustion.py) and is excluded here;
PulsatileBloodFlow2D takes --N instead of a config and gets its own
test below.
"""
import os

import pytest

from multiphase_lbm_tpu.runners import coolbm

# problem -> (shipped config to shrink, expected output file fragments)
CASES = {
    "laplace2D_sc": ("sc_Laplace2D.txt", ["sol_", "mass.dat"]),
    "contactAngle2D": ("sc_contactAngle2D.txt", ["contact_angle.dat"]),
    "twoLayeredFlow2D_sc": ("sc_twoLayeredFlow2D.txt", ["sol_"]),
    "RayleighTaylor2D_sc": ("sc_RayleighTaylor2D.txt", ["sol_"]),
    "Young_Laplace2D": ("young_laplace2D.txt", ["sol_", "energy.dat"]),
    "rayleighTaylor2D": ("pf_rayleighTaylor2D.txt",
                         ["spike_bubble_position.dat"]),
    "twoLayeredFlow2D": ("pf_twoLayeredFlow2D.txt", ["density_probe.dat"]),
    "laplace3D": ("pf_laplace3D.txt", ["sol_"]),
}

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def _tiny_config(src, dst, n=16):
    lines = []
    for line in open(src):
        key = line.split()[0] if line.strip() and not line.startswith("#") \
            else None
        if key == "N":
            line = f"N    {n}\n"
        lines.append(line)
    with open(dst, "w") as fh:
        fh.writelines(lines)


def test_pulsatile_cli_runs_end_to_end(tmp_path):
    outdir = tmp_path / "out"
    rc = coolbm.main(["PulsatileBloodFlow2D", "--N", "16",
                      "--outdir", str(outdir), "--steps", "2"])
    assert rc == 0
    produced = os.listdir(outdir)
    assert any(name.startswith("sol_") for name in produced), produced


def _run_problem(problem, tmp_path, *extra):
    config_name, expected = CASES[problem]
    cfg = tmp_path / "config.txt"
    _tiny_config(os.path.join(CONFIG_DIR, config_name), cfg)
    outdir = tmp_path / "out"
    rc = coolbm.main([problem, "--config", str(cfg),
                      "--outdir", str(outdir), "--steps", "2", *extra])
    assert rc == 0
    produced = os.listdir(outdir)
    for frag in expected:
        assert any(frag in name for name in produced), (
            f"{problem}: no output matching {frag!r} in {produced}")


@pytest.mark.parametrize("problem", sorted(CASES))
def test_problem_runs_end_to_end(problem, tmp_path):
    _run_problem(problem, tmp_path)


@pytest.mark.parametrize("problem", sorted(CASES))
def test_problem_runs_end_to_end_f32(problem, tmp_path):
    _run_problem(problem, tmp_path, "--f32")


def test_default_dtype_is_really_float64(tmp_path):
    """Without ``--f32`` the CLI computes in float64: it turns on
    ``jax_enable_x64`` itself (a fresh process, outside this suite's
    conftest, which enables x64 for every test)."""
    import subprocess
    import sys

    cfg = tmp_path / "config.txt"
    _tiny_config(os.path.join(CONFIG_DIR, "sc_Laplace2D.txt"), cfg)
    code = f"""
import jax
from multiphase_lbm_tpu.runners import coolbm
seen = []
run, needs_cfg = coolbm.PROBLEMS["laplace2D_sc"]
coolbm.PROBLEMS["laplace2D_sc"] = (
    lambda *a, **k: seen.append(run(*a, **k).dtype), needs_cfg)
coolbm.main(["laplace2D_sc", "--config", {str(cfg)!r},
             "--outdir", {str(tmp_path / "out")!r}, "--steps", "2"])
print(seen[0], jax.config.jax_enable_x64)
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-2:] == ["float64", "True"]


def test_pulsatile_dump_cadence(tmp_path, monkeypatch):
    """The runner must land each chunk's LAST step on the reference's
    tf/100 dump cadence (archived run: sol_0000000, sol_0000027, …).
    A fixed stride from t=0 lands on t ≡ step_freq−1 and writes only the
    final dump.  Checked with the physics stubbed out (pure loop
    arithmetic + dump labels)."""
    from multiphase_lbm_tpu.models import pulsatile as pb
    from multiphase_lbm_tpu.runners import apps, common

    import numpy as np

    class _Stub:
        P = Ux = Uy = np.zeros((4, 4))
        fluid = np.ones((4, 4), bool)

    calls = []
    monkeypatch.setattr(pb, "initialize", lambda p, dtype: _Stub())
    monkeypatch.setattr(pb, "run",
                        lambda st, t0, p, n: calls.append((t0, n)) or st)
    dumps = []
    monkeypatch.setattr(common.Driver, "write_vtk",
                        lambda self, it, *a, **k: dumps.append(it))
    apps.run_pulsatile(tmp_path, N=64, max_steps=270)

    # tf=270 -> step_freq=2: dumps at 0, 2, ..., 270
    assert dumps == list(range(0, 271, 2))
    # chunks tile the run exactly: first step of each chunk follows the
    # previous dump, last step IS the dump instant
    t = 0
    for (t0, n), d in zip(calls, dumps):
        assert t0 == t and t0 + n - 1 == d
        t = d + 1


def test_driver_lands_on_both_cadences(tmp_path):
    """Mismatched out_freq/vtk_freq cadences must BOTH be honored: the
    loop chunks to the nearest multiple of either (common.next_chunk).
    Regression for the fixed-stride chunking that skipped vtk instants
    not divisible by out_freq."""
    src = os.path.join(CONFIG_DIR, "sc_Laplace2D.txt")
    cfg = tmp_path / "cfg.txt"
    lines = []
    for line in open(src):
        key = line.split()[0] if line.strip() and not line.startswith("#") \
            else None
        if key == "N":
            line = "N    16\n"
        elif key == "out_freq":
            line = "out_freq    3\n"
        elif key == "vtk_freq":
            line = "vtk_freq    5\n"
        lines.append(line)
    cfg.write_text("".join(lines))
    outdir = tmp_path / "out"
    rc = coolbm.main(["laplace2D_sc", "--config", str(cfg),
                      "--outdir", str(outdir), "--steps", "11"])
    assert rc == 0
    sols = sorted(f for f in os.listdir(outdir) if f.startswith("sol_"))
    assert sols == ["sol_0000000.vtk", "sol_0000005.vtk",
                    "sol_0000010.vtk"], sols
    # energy.dat logged at every out_freq multiple < steps
    steps_logged = [float(r.split()[0])
                    for r in (outdir / "energy.dat").read_text().split("\n")
                    if r.strip()]
    assert len(steps_logged) == 4           # it = 0, 3, 6, 9
