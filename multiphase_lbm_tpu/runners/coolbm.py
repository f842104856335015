"""Problem-select CLI, the counterpart of the reference's ``COOLBM.cpp``
mains (problem chosen by string, reference ``Abbashub LBM/apps/COOLBM.cpp:99``)
— but selectable at runtime instead of recompiling:

    python -m multiphase_lbm_tpu.runners.coolbm <problem> \
        [--config config.txt] [--outdir out] [--steps N] [--f32]

Problems: laplace2D_sc, contactAngle2D, twoLayeredFlow2D_sc,
RayleighTaylor2D_sc, Young_Laplace2D, rayleighTaylor2D, twoLayeredFlow2D,
laplace3D, PulsatileBloodFlow2D, combustion.
"""
from __future__ import annotations

import argparse
import sys

import jax.numpy as jnp

from ..utils.runtime import configure_compile_cache, enable_x64_for
from . import apps

PROBLEMS = {
    "laplace2D_sc": (apps.run_sc_laplace2d, True),
    "contactAngle2D": (apps.run_sc_contact_angle, True),
    "twoLayeredFlow2D_sc": (apps.run_sc_two_layered, True),
    "RayleighTaylor2D_sc": (apps.run_rayleigh_taylor_sc, True),
    "Young_Laplace2D": (apps.run_young_laplace2d, True),
    "rayleighTaylor2D": (apps.run_rayleigh_taylor_pf, True),
    "twoLayeredFlow2D": (apps.run_two_layered_pf, True),
    "laplace3D": (apps.run_laplace3d, True),
}

REFERENCE_CONFIGS = {
    "laplace2D_sc": "shan-chen single component model/apps/Config_Files/config_Laplace2D.txt",
    "contactAngle2D": "shan-chen single component model/apps/Config_Files/config_contactAngle2D.txt",
    "twoLayeredFlow2D_sc": "shan-chen single component model/apps/Config_Files/config_twoLayeredFlow2D.txt",
    "RayleighTaylor2D_sc": "shan-chen single component model/apps/Config_Files/config_RayleighTaylor2D.txt",
    "Young_Laplace2D": "Abbashub LBM/apps/Config_Files/config_laplace2D.txt",
    "rayleighTaylor2D": "Phase field model/apps/Config_Files/config_rayleighTaylor2D.txt",
    "twoLayeredFlow2D": "Phase field model/apps/Config_Files/config_twoLayeredFlow2D.txt",
    "laplace3D": "Phase field model/apps/Config_Files/config_laplace3D.txt",
}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="coolbm")
    ap.add_argument("problem", choices=list(PROBLEMS) +
                    ["PulsatileBloodFlow2D", "combustion"])
    ap.add_argument("--config", default=None,
                    help="reference-format config_*.txt (defaults to the "
                         "reference's shipped config when available)")
    ap.add_argument("--outdir", default="out")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the step count from the config")
    ap.add_argument("--f32", action="store_true",
                    help="run in float32 (default: float64, as the "
                         "reference computes)")
    ap.add_argument("--quirk-free", action="store_true",
                    help="PulsatileBloodFlow2D: physics mode "
                         "(momentum_quirk=False — true first moment, "
                         "standard collide-stream input, consistent MRT "
                         "basis, Zou/He corner closures; see "
                         "validation/womersley.py findings) instead of "
                         "the reference-parity quirks")
    ap.add_argument("--N", type=int, default=64,
                    help="resolution for PulsatileBloodFlow2D")
    ap.add_argument("--scheme", default="li2014",
                    choices=["li2014", "guo2015", "huber2015", "none"],
                    help="conjugate-heat scheme for the combustion problem")
    ap.add_argument("--topology", default="inflow_outflow",
                    choices=["inflow_outflow", "cavity", "couette",
                             "poiseuille"],
                    help="combustion domain topology (reference global "
                         "flags, CooLBM_MRT_combustion.cpp:154-254; "
                         "geometry branches :3756-4073)")
    ap.add_argument("--u-lid", type=float, default=None,
                    help="combustion lid/moving-wall speed for cavity/"
                         "couette (default: reference ulb 0.002 there, "
                         ":53; inert 0.0 for the other topologies)")
    ap.add_argument("--dpdx", type=float, default=0.0,
                    help="combustion body force for poiseuille "
                         "(reference efx, :239)")
    ap.add_argument("--restart", default=None, metavar="INI_F",
                    help="combustion: warm-start the flow from a "
                         "reference-format ini_f.dat (skips the "
                         "flow-convergence stage, reference :4345)")
    ap.add_argument("--bench", action="store_true",
                    help="combustion: benchmark mode (warmup + timed MLUPS "
                         "window, reference :4376-4380)")
    ap.add_argument("--scalar-steps", type=int, default=5000,
                    help="combustion: reactive-stage step count")
    ap.add_argument("--nx", type=int, default=420,
                    help="combustion lattice size (reference N_X=420)")
    ap.add_argument("--ny", type=int, default=80,
                    help="combustion lattice size (reference N_Y=80)")
    args = ap.parse_args(argv)

    dtype = jnp.float32 if args.f32 else jnp.float64
    configure_compile_cache()
    enable_x64_for(dtype)

    if args.problem == "PulsatileBloodFlow2D":
        apps.run_pulsatile(args.outdir, N=args.N, dtype=dtype,
                           max_steps=args.steps,
                           momentum_quirk=not args.quirk_free)
        return 0
    if args.problem == "combustion":
        apps.run_combustion(args.outdir, nx=args.nx, ny=args.ny, dtype=dtype,
                            flow_steps=args.steps or 20000,
                            scalar_steps=args.scalar_steps,
                            conj_scheme=args.scheme,
                            restart=args.restart,
                            benchmark=args.bench,
                            topology=args.topology,
                            u_lid=args.u_lid, dpdx=args.dpdx)
        return 0

    fn, needs_cfg = PROBLEMS[args.problem]
    cfg = args.config
    if cfg is None:
        import os
        from pathlib import Path
        repo_cfg = {
            "laplace2D_sc": "sc_Laplace2D.txt",
            "contactAngle2D": "sc_contactAngle2D.txt",
            "twoLayeredFlow2D_sc": "sc_twoLayeredFlow2D.txt",
            "RayleighTaylor2D_sc": "sc_RayleighTaylor2D.txt",
            "Young_Laplace2D": "young_laplace2D.txt",
            "rayleighTaylor2D": "pf_rayleighTaylor2D.txt",
            "twoLayeredFlow2D": "pf_twoLayeredFlow2D.txt",
            "laplace3D": "pf_laplace3D.txt",
        }
        cand1 = (Path(__file__).resolve().parents[2] / "configs"
                 / repo_cfg[args.problem])
        cand2 = os.path.join("/root/reference", REFERENCE_CONFIGS[args.problem])
        if cand1.exists():
            cfg = str(cand1)
        elif os.path.exists(cand2):
            cfg = cand2
        else:
            ap.error(f"--config required for {args.problem}")
    fn(cfg, args.outdir, dtype=dtype, max_steps=args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
