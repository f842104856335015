"""Process set-up shared by every entry point.

* :func:`configure_compile_cache` — one persistent XLA compile cache:
  ``$JAX_COMPILATION_CACHE_DIR`` when the environment sets it, else the
  fixed ``<repo>/.jax_cache`` (the path is part of the cache key, so it
  must not move between runs).
* :func:`enable_x64_for` — a float64 run needs ``jax_enable_x64``, or
  JAX silently computes it in float32.
* :func:`require_gpu`, :func:`device_record`, :func:`card_line` — what a
  measurement needs: the device it ran on, and the card's name and power
  limit read by ``nvidia-smi`` in a child process that never imports JAX.
"""
from __future__ import annotations

import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=None) -> str:
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO, ".jax_cache")


def configure_compile_cache() -> str:
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def enable_x64_for(dtype) -> None:
    import jax
    import numpy as np

    if np.dtype(dtype) == np.float64:
        jax.config.update("jax_enable_x64", True)


def require_gpu():
    """The devices, if JAX's default backend is a GPU; else SystemExit.
    Measurements never fall back to the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is "
                         f"{devs[0].platform!r} ({devs[0].device_kind})")
    return devs


def device_record() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_line() -> str:
    """``name, power.limit`` of each card, one line per card."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def peak_bytes(device=None) -> int | None:
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")
