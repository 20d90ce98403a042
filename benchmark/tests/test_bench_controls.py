"""On the card: the program must come out correct, and each control and
planted fault of a cell's driver (``STAND_INS``, put in the program's
place), not correct, through the harness's own comparison, at the cell's
own batch and shapes with a short ring and window. Skips without a
card; run on the card with

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests/test_bench_controls.py
"""

import importlib
import os
import time

import pytest
import torch

from benchmark import harness

SPEC = harness.spec_of()
SEED = 9_000_000_017


def traffic_of(cell):
    return harness.load_json(os.path.join(harness.HERE, "traffic",
                                          f"{cell['traffic']}.json"))


CASES = [(c["name"], kind) for c in SPEC["workloads"]
         for kind in [None] + list(importlib.import_module(
             f"benchmark.drivers.{traffic_of(c)['driver']}").STAND_INS)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,stand_in", CASES)
def test_control_fails_and_program_passes(name, stand_in):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.cell_of(SPEC, name)
    traffic = traffic_of(cell)
    if traffic["driver"] == "train":
        traffic["ring"] = 3
    else:
        traffic.update(ring=2 * traffic["scenes_per_call"], checked_calls=2)
    run = harness.run_cell(cell, SEED, 2.0, False, time.time(),
                           traffic=traffic, stand_in=stand_in)
    assert run.correct() == (stand_in is None), run.checks
