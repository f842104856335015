"""Test harness: an 8-device virtual CPU mesh and float64.

With ``JAX_PLATFORMS`` unset the suite is pinned to the CPU, where the
model paths are validated in float64 against the reference captures.
Tests marked ``gpu`` need a GPU and skip without one; run them on the
card with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""
import os
import sys

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# silence the per-load AOT "machine feature" warnings from the persistent
# cache (XLA pseudo-features like prefer-no-scatter trip a string diff;
# compile and execution happen on the same host)
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from multiphase_lbm_tpu.utils.runtime import configure_compile_cache  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compilation cache: the suite is dominated by XLA-CPU compiles
# of large scan graphs (30-90 s each); caching them on disk makes re-runs
# compile-free.  Keys include the HLO, so source changes invalidate
# automatically.
configure_compile_cache()

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual CPU devices, got {len(devs)}"
    return devs


@pytest.fixture(scope="session")
def gpu():
    """The GPU device, for tests marked ``gpu``; skips without one.
    Decided here, at run time, never at import or collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device: {dev.platform})")
    return dev


@pytest.fixture(scope="module", autouse=True)
def _shed_compiler_state():
    """Drop accumulated compiled executables between test modules.

    The XLA CPU compiler segfaults nondeterministically (~50% of full-suite
    runs, always in `backend_compile` of a LATE module's big scan graph —
    observed in test_sharding and test_pulsatile on different runs) once a
    long pytest process has accumulated hundreds of compiled programs.
    Clearing the executable caches at module boundaries keeps the native
    compiler state small; module-scoped fixtures recompile, which costs
    ~1 min across the suite and has eliminated the crash in validation
    runs."""
    jax.clear_caches()
    yield
