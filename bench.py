#!/usr/bin/env python
"""Headline benchmark: D2Q9 MRT + Shan-Chen on a 2048² lattice, one GPU.

    python bench.py [--reps N]

Times the model's jitted XLA step (the ``sc`` workload of
``multiphase_lbm_tpu.runners.bench_suite``) and prints ONE JSON line:
``{"metric", "value", "unit", ...}`` with the device (platform, kind,
count) and the card's name and power limit.  MLUPS definition identical
to the reference (printMlups_*): nelem · iterations / microseconds.
Without a GPU it exits nonzero and prints no result.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions (median reported)")
    args = ap.parse_args(argv)

    from multiphase_lbm_tpu.runners import bench_suite
    from multiphase_lbm_tpu.utils.runtime import (card_line,
                                                  configure_compile_cache,
                                                  device_record, require_gpu)

    configure_compile_cache()
    require_gpu()
    rec = bench_suite.run_workload("sc", reps=args.reps)
    print(json.dumps({
        "metric": "MLUPS_D2Q9_MRT_ShanChen_2048x2048_XLA",
        "value": rec["mlups"], "unit": "MLUPS",
        "ms_per_step": rec["ms_per_step"], "spread": rec["spread"],
        "peak_bytes_in_use": rec["peak_bytes_in_use"],
        "device": {**device_record(), "card": card_line()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
