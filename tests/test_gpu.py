"""The chip_smoke phases at real widths, as tests that need a GPU.

They skip without one (the ``gpu`` fixture decides at run time).  On the
card:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q
"""
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module", autouse=True)
def _compile_timing():
    import jax
    jax.monitoring.register_event_duration_secs_listener(chip_smoke._on_event)


def test_cli_reference_runs(gpu, tmp_path):
    chip_smoke.phase_a(str(tmp_path))


def test_headline_f32_against_f64(gpu):
    chip_smoke.phase_b()


def test_benchmark_workloads_f32_against_f64(gpu):
    chip_smoke.phase_c()


def test_cpp_and_golden_captures(gpu):
    chip_smoke.phase_d()


def test_four_card_halo_path(gpu):
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs four GPUs")
    chip_smoke.phase_e()
