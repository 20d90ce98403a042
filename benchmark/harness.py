"""The benchmark's harness: one cell, one seed, one run.

Everything is found by name. ``BENCHMARK.json`` names the cell's
configuration (``benchmark/configs/<config>.json``), its traffic
(``benchmark/traffic/<traffic>.json``, whose ``driver`` names the loop
in ``benchmark/drivers/``) and its metrics; each per-layer metric is
read by ``benchmark/metrics/<metric>.py``; the limits that decide
``correct`` are ``benchmark/limits/<cell>.json``. A later change adds a
cell, a configuration, a mix or a metric as new files and entries."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dropclip_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def spec_of(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_of(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    """The module ``benchmark/metrics/<name>.py`` (its ``read(run)``)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """One run of a cell: its inputs, and what its driver records."""

    def __init__(self, cell: Dict, config: Dict, traffic: Dict,
                 limits: Dict, seed: int, seconds: float, trace: bool,
                 t_start: float, device: str = "cuda",
                 stand_in: Optional[str] = None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits = limits["limits"]
        self.not_compared = limits.get("not_compared", {})
        # a control or planted fault of the driver's STAND_INS, put in
        # the program's place for the comparison (calibration and tests)
        self.stand_in = stand_in
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.t_start, self.device = t_start, device
        self.root = ROOT
        self.e2e: Dict[str, float] = {}
        self.work: Dict[str, float] = {}   # work of one profiled unit
        self.counters: Dict[str, float] = {}
        self.probe = None                   # trace.Probe of a traced run
        self.checks: List[tuple] = []      # (name, value, limit)
        self.readings: Dict[str, float] = {}  # numbers not compared
        self.attempted = self.failed = 0
        self.memory_peak = 0

    def setup_done(self) -> None:
        """Set-up ends here: the first timed call comes next."""
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
        self.e2e["setup_s"] = time.time() - self.t_start

    def check(self, name: str, value: float) -> None:
        """A number compared: passes where it is at most its limit."""
        self.checks.append((name, float(value), float(self.limits[name])))

    def compare(self, numbers: Dict[str, float]) -> None:
        """Every number with a limit is compared; one that the cell's
        limits file names under ``not_compared`` (with the reason) is kept
        as a reading; any other is an error, so that no check drops out
        of ``correct`` unseen."""
        for name, value in numbers.items():
            if name in self.limits:
                self.check(name, value)
            elif name in self.not_compared:
                self.readings[name] = float(value)
            else:
                raise KeyError(f"{name!r} has no limit in limits/"
                               f"{self.cell['name']}.json and is not "
                               "named under not_compared")

    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim
                                         in self.checks)


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             config: Optional[Dict] = None,
             traffic: Optional[Dict] = None,
             stand_in: Optional[str] = None) -> Run:
    """Set-up, window, traced sub-window and comparison of one cell;
    ``config`` and ``traffic`` stand in for the cell's files (tests),
    ``stand_in`` names a control or fault judged in the program's place
    (calibration and tests)."""
    config = config or load_json(os.path.join(HERE, "configs",
                                              f"{cell['config']}.json"))
    traffic = traffic or load_json(os.path.join(HERE, "traffic",
                                                f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "limits", f"{cell['name']}.json"))
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    if stand_in is not None and stand_in not in driver.STAND_INS:
        raise KeyError(f"driver {traffic['driver']!r} has no stand-in "
                       f"{stand_in!r}; it has {sorted(driver.STAND_INS)}")
    run = Run(cell, config, traffic, limits, seed, seconds, trace, t_start,
              device, stand_in)
    driver.run(run)
    return run


def card_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result_of(spec: Dict, run: Run, chips: int) -> Dict:
    """The result line's object."""
    name = run.cell["name"]
    metrics = {}
    if run.trace:
        for m in spec["per_layer"]:
            if not applies(m, name):
                continue
            value = reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if run.device == "cuda" else run.device,
              "kind": card_name() if run.device == "cuda" else run.device,
              "count": chips, "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": run.correct(), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.probe is not None:
        device["busy_s"] = run.probe.busy_s()
        device["window_s"] = run.probe.window_s
        out["breakdown"] = run.probe.breakdown()
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, v, lim in run.checks}
    return out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = spec_of()
    cell = cell_of(spec, args.workload)

    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {power_limit()}; peaks: bf16 989 TFLOP/s, TF32 495, "
          "float32 as 3xTF32 165, HBM 3.35 TB/s", flush=True)
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    out = result_of(spec, run, chips)
    for n, v in run.readings.items():
        print(f"reading {n} {v!r} (not compared)", file=sys.stderr)
    for n, v, lim in run.checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
