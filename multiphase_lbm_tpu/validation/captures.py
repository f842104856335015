"""Comparisons against the repository's C++ and golden captures.

Each function runs the model from scratch on JAX's default device and
returns rows ``(label, error, tolerance)``; a row passes when
``error <= tolerance``.  The CI tests (tests/test_combustion_parity.py,
tests/test_sc_variants.py, tests/test_rti_regression.py) and
``chip_smoke.py`` phase (d) both call them, so the card is held to the
same gates as the CPU.  Capture protocols: BASELINE.md.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"

# field → (absolute tolerance at the reference's float-print precision,
#          compare over obstacle cells too)
COMBUSTION_FIELDS = {
    "Density": (1e-5, False),
    "velocity_X": (1e-6, False),
    "velocity_Y": (1e-6, False),
    "Temperature": (1e-5, True),
    "mass_fraction_O2": (2e-6, False),
    "mass_fraction_CO2": (2e-6, False),
}


def combustion_parity():
    """128×48 combustion channel vs the instrumented C++ run, every VTK
    field at steps 100..500 (binary-faithful ``first_step=True`` mode; see
    tests/test_combustion_parity.py for what the capture contains)."""
    import jax

    from ..models import combustion as cb

    cap = np.load(DATA / "combustion_reference.npz")
    flag = cap["flag"]
    bulk = flag == 0
    obst = flag == 2

    p = cb.CombustionParams(nx=128, ny=48)
    flags, _ = cb.build_geometry(p)
    st = cb.initialize(p, flags=flags)
    step, _ = cb.make_step(p, konv=True, first_step=True)

    @jax.jit
    def chunk100(s):
        return jax.lax.fori_loop(0, 100, lambda _, t: step(t), s)

    rows = []
    for tgt in (100, 200, 300, 400, 500):
        st = chunk100(st)
        rho, u = cb.macro_flow(st.f)
        ours = {
            "Density": np.asarray(rho),
            "velocity_X": np.asarray(u[0]),
            "velocity_Y": np.asarray(u[1]),
            "Temperature": np.asarray(cb.macro_scalar(st.gT)),
            "mass_fraction_O2": np.asarray(cb.macro_scalar(st.gO2)),
            "mass_fraction_CO2": np.asarray(cb.macro_scalar(st.gCO2)),
        }
        for name, (tol, with_obst) in COMBUSTION_FIELDS.items():
            sel = bulk | obst if with_obst else bulk
            d = np.abs(ours[name] - cap[f"{name}_{tgt}"])[sel].max()
            rows.append((f"{name}@{tgt}", float(d), tol))
    return rows


def scrt_parity():
    """SC Rayleigh–Taylor (shipped config, N=128) density profiles along
    the two interface probe columns at step 250 vs the C++ dump, at the
    reference's float output precision (``assert_allclose(atol=5e-5)``:
    error is ``|a − d| − 1e-7·|d|``)."""
    import jax.numpy as jnp

    from ..io.config import lb_parameters
    from ..models import shan_chen_rt as rt

    data = np.load(DATA / "scrt_reference.npz")
    nu, omega, dx, dt = lb_parameters(0.04, 128, 30.72)
    p = rt.SCRTParams(omega=omega, rhol=1.2, rhog=0.4, g=-5.0,
                      gravity=-1.25e-5)
    nx, ny = 128, 4 * 128 + 2         # reference dim {N, 4N+2}
    f = rt.init_interface(nx, ny, p, dtype=jnp.float64)
    fluid = rt.geometry_channel(nx, ny)
    f = f * fluid[None].astype(f.dtype)
    f = rt.run(f, fluid, p, 250)
    rho = np.asarray(rt.density(f))
    interior = np.ones(ny, bool)
    interior[0] = interior[-1] = False
    rows = []
    for name, col in (("col0", 0), ("colmid", nx // 2)):
        ref = np.asarray(data[f"rho_{name}_250"], dtype=np.float64)[interior]
        err = np.abs(rho[interior, col] - ref) - 1e-7 * np.abs(ref)
        rows.append((name, float(err.max()), 5e-5))
    return rows


def hcz_golden():
    """40-step N=64 HCZ Rayleigh–Taylor run vs the stored f64 snapshot
    (``assert_allclose(rtol=1e-12, atol=1e-14)``: error is
    ``|a − d| − 1e-12·|d|``), so any numerical change in models/hcz.py
    shows."""
    import jax.numpy as jnp

    from ..io.config import lb_parameters
    from ..models import hcz

    d = np.load(DATA / "hcz_golden_n64.npz")
    N, ny, steps = (int(v) for v in d["meta"])
    nu, omega, dx, dt = lb_parameters(0.04, N, 3000.0)
    p = hcz.HCZParams(omega=omega, gravity=-0.04 * 0.04 / N, kappa=0.01)
    st = hcz.init_rayleigh_taylor(N, ny, p, dtype=jnp.float64)
    fluid = hcz.geometry_channel(N, ny)
    st = hcz.apply_geometry(st, fluid)
    st = hcz.run(st, fluid, p, steps)
    rows = []
    for name, got in (("f", st[0]), ("g", st[1])):
        err = np.abs(np.asarray(got) - d[name]) - 1e-12 * np.abs(d[name])
        rows.append((name, float(err.max()), 1e-14))
    return rows
