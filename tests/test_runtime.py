"""Entry-point plumbing: the compile cache, the refusal to measure without
a GPU, and chip_smoke's phase selection and last line."""
import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from multiphase_lbm_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir(env_dir, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import jax; from multiphase_lbm_tpu.utils.runtime import "
            "configure_compile_cache as c; p = c(); "
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want, want]
    assert runtime.compile_cache_dir(env) == want


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    r = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout and "MLUPS" not in r.stdout
    assert "no GPU" in r.stderr


def test_multi_selects_only_its_phase():
    cs = chip_smoke
    assert cs.phases(multi=True) == [cs.phase_e]
    assert cs.phases(multi=False) == [cs.phase_a, cs.phase_b, cs.phase_c,
                                      cs.phase_d]


def test_multi_phase_on_virtual_devices(eight_devices, capsys):
    """Phase e's path (halo step on a 1D mesh of 4 and a 2×2 mesh against
    one device) at a tiny lattice on virtual CPU devices."""
    chip_smoke.phase_e(n=32, steps=2)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and all(l.endswith("PASS") for l in lines)
    assert "halo mesh {'y': 2, 'x': 2}" in lines[2]


def test_last_line():
    line = chip_smoke.last_line({"platform": "gpu", "count": 1,
                                 "kind": "NVIDIA H100 80GB HBM3"})
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["ok"] is True


def test_measure_mlups_median_and_spread(monkeypatch):
    """The one timing function: a warm-up call, then the median of the
    reps, each ended by ``jax.block_until_ready``."""
    import jax
    from multiphase_lbm_tpu.utils import profiling

    clock = iter([0.0, 5.0,                       # warm-up (compile)
                  10.0, 10.2, 20.0, 20.4, 30.0, 30.3])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    waited = []
    monkeypatch.setattr(jax, "block_until_ready",
                        lambda x: waited.append(x) or x)
    m = profiling.measure_mlups(lambda s: s + 1, 0, n_steps=10,
                                nelem=1_000_000, reps=3)
    assert waited == [1, 1, 1, 1]
    assert m["first_call_s"] == 5.0
    assert abs(m["ms_per_step"] - 30.0) < 1e-9          # median 0.3 s / 10
    assert abs(m["mlups"] - 1e6 * 10 / 0.3 / 1e6) < 1e-6
    assert abs(m["spread"] - (0.4 - 0.2) / 0.3) < 1e-9


def test_phase_a_output_check(tmp_path):
    """chip_smoke's CLI check finds the run's VTK and .dat files, counts
    non-finite values in them, and raises when a file is missing."""
    from multiphase_lbm_tpu.runners import coolbm

    cfg = tmp_path / "config.txt"
    lines = open(os.path.join(REPO, "configs", "sc_Laplace2D.txt")).read()
    cfg.write_text(lines.replace("N            100", "N            16"))
    out = tmp_path / "out"
    coolbm.main(["laplace2D_sc", "--config", str(cfg), "--outdir", str(out),
                 "--steps", "2"])
    assert chip_smoke._nonfinite_in_outputs(str(out)) == (0, 1)
    with open(out / "mass.dat", "a") as fh:
        fh.write("2 nan\n")
    assert chip_smoke._nonfinite_in_outputs(str(out))[0] == 1
    os.remove(out / "sol_0000000.vtk")
    with pytest.raises(FileNotFoundError):
        chip_smoke._nonfinite_in_outputs(str(out))
