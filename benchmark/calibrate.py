#!/usr/bin/env python3
"""Readings behind the limits of a cell's comparison: the program
against the plain reference on many seeds, and each control or planted
fault of the cell's driver (``STAND_INS``, put in the program's place)
on the first few, each a run of the harness with a short window, all in
one process.

    python3 benchmark/calibrate.py --workload mvtod.train --seeds 12 --faults 3

Prints one JSON line per seed and run, then the largest program reading
and the smallest reading of each stand-in, of every number."""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import importlib
    import json

    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=7_000_000_011)
    args = ap.parse_args(argv)
    cell = harness.cell_of(harness.spec_of(), args.workload)
    traffic = harness.load_json(os.path.join(harness.HERE, "traffic",
                                             f"{cell['traffic']}.json"))
    driver = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}")
    lo, hi = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        kinds = [None] + (list(driver.STAND_INS) if i < args.faults else [])
        for kind in kinds:
            t = time.time()
            run = harness.run_cell(cell, seed, args.seconds, False, t,
                                   stand_in=kind)
            nums = {**{n: v for n, v, _ in run.checks}, **run.readings}
            print(json.dumps({"seed": seed, "kind": kind or "program",
                              "correct": run.correct(), **nums,
                              "s": round(time.time() - t, 1)}), flush=True)
            for k, v in nums.items():
                if kind is None:
                    lo[k] = max(lo.get(k, 0.0), v)
                else:
                    hi.setdefault(kind, {})[k] = min(
                        hi.get(kind, {}).get(k, float("inf")), v)
            del run
    print(json.dumps({"lower": lo, "upper": hi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
