#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic and its metrics are found by
name from BENCHMARK.json at the root of the checkout. The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device, and with ``--trace 1`` breakdown; the numbers compared, each
beside its limit, under ``checks``). Exits non-zero, printing no result,
without a CUDA card or with fewer than the cell asks for, and where JAX
or the JAX package was loaded."""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every compile cache at a fixed path inside the checkout, set before the
# program or Triton is imported
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
