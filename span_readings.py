"""Readings behind the program's spans (``dropclip_tpu_torch/core/
spans.py``) and the benchmark metrics that read them, on one card.

    python3 span_readings.py sync --cell mvtod.serve
        one unit of the cell (a ``ground_batch`` call, a train step),
        warm, under ``torch.cuda.set_sync_debug_mode("warn")``: every
        synchronising op the unit runs, by the line of the program that
        called it, with the calls above it
    python3 span_readings.py cost
        the cost of one span, the profiler off (no session) and on (a CPU
        and CUDA session, as the benchmark's traced window), and of a
        decorated call against a plain one
    python3 span_readings.py trace --cell mvtod.train --seed 7 \\
        [--seconds 51] [--tree DIR]
        one run of the cell as ``benchmark/run.py --trace 1`` makes it,
        from the checkout at ``DIR`` (this one by default): its result
        line, then how the spans account for the traced units (each
        root's self share, the idle time under no span, the traced unit
        time); the spans and kernels of the traced window go to
        ``chiprun_out/spans/<tree>.<cell>.<seed>.json.gz``

Each command prints one JSON line last."""

import argparse
import gzip
import importlib
import json
import os
import sys
import time
import traceback
import warnings

T_START = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "spans")


def use_tree(tree: str) -> None:
    """Import the benchmark and the program from ``tree``."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(tree, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, tree)


def cell_run(name: str, seed: int, seconds: float, traced: bool):
    """A ``harness.Run`` of the cell and its driver module."""
    from benchmark import harness

    here = os.path.dirname(harness.__file__)
    cell = harness.cell_of(harness.spec_of(), name)
    config = harness.load_json(os.path.join(here, "configs",
                                            f"{cell['config']}.json"))
    traffic = harness.load_json(os.path.join(here, "traffic",
                                             f"{cell['traffic']}.json"))
    limits = harness.load_json(os.path.join(here, "limits", f"{name}.json"))
    run = harness.Run(cell, config, traffic, limits, seed, seconds, traced,
                      T_START)
    return run, importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}")


def warm_unit(run, driver):
    """One warm unit of the cell, as a function of no argument."""
    b = driver.build(run)
    if hasattr(driver, "program_first_steps"):
        state, step, feed = b["state"], b["step"], b["feed"]
        driver.program_first_steps(state, step, feed, 2)
        return lambda: step(state, feed[0])
    pipe, traffic = b["pipe"], b["traffic"]
    driver.ground(pipe, traffic, 0)
    return lambda: driver.ground(pipe, traffic, 1)


def sync(args) -> dict:
    import torch

    use_tree(ROOT)
    run, driver = cell_run(args.cell, args.seed, 1.0, False)
    unit = warm_unit(run, driver)
    unit()
    torch.cuda.synchronize()
    sites = {}

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()
                  if "dropclip_tpu_torch" in f.filename]
        key = " <- ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} "
                          f"{f.name}" for f in reversed(frames[-4:]))
        site = sites.setdefault(key, {"count": 0,
                                      "warning": str(message)[:120]})
        site["count"] += 1

    saved = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            unit()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = saved
    torch.cuda.synchronize()
    for key, site in sorted(sites.items()):
        print(f"{site['count']:3d}  {key}\n     {site['warning']}")
    return {"cell": args.cell, "syncs": sum(s["count"]
                                            for s in sites.values()),
            "sites": {k: s["count"] for k, s in sites.items()}}


def cost(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    use_tree(ROOT)
    from dropclip_tpu_torch.core.spans import span

    torch.ones(1, device="cuda")

    def per_call(fn, n):
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter()
            fn(n)
            best = min(best, (time.perf_counter() - t) / n)
        return best * 1e6

    def spans(n):
        for _ in range(n):
            with span("cost"):
                pass

    def bare(n):
        for _ in range(n):
            pass

    def plain():
        return None

    decorated = span("cost.call")(plain)

    def calls(fn):
        def loop(n):
            for _ in range(n):
                fn()
        return loop

    out = {"card": torch.cuda.get_device_name(0)}
    out["off_us"] = per_call(spans, 200000) - per_call(bare, 200000)
    out["off_call_us"] = (per_call(calls(decorated), 200000)
                          - per_call(calls(plain), 200000))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["on_us"] = per_call(spans, 2000) - per_call(bare, 2000)
    return out


def trace_run(args) -> dict:
    tree = os.path.abspath(args.tree or ROOT)
    use_tree(tree)
    from benchmark import harness, spans

    run, driver = cell_run(args.cell, args.seed, args.seconds, True)
    driver.run(run)
    spec = harness.spec_of()
    print(json.dumps(harness.result_of(spec, run, 1)), flush=True)
    p = run.probe
    named = spans.named(p, lambda n: True)
    root = "train.step" if "train" in args.cell else "serve.call"
    roots = spans.named(p, root)
    acct = {"tree": os.path.relpath(tree, ROOT), "cell": args.cell,
            "seed": args.seed, "units": len(p.units),
            "unit_ms": 1e3 * p.window_s / len(p.units),
            "window_s": p.window_s, "busy_s": p.busy_s(), "roots": len(roots)}
    if roots:
        children = [s for s in named if s not in roots]
        self_share = []
        for u in roots:
            cover = spans.union(spans.inside(children, u))
            self_share.append(1 - sum(e - s for s, e in cover)
                              / (u[1] - u[0]))
        idle = p.window_s - p.busy_s()
        acct["root_self_share_max"] = max(self_share)
        acct["idle_s"] = idle
        acct["idle_under_no_span_s"] = idle - spans.idle_within(p, named)
        acct["idle_under_no_child_s"] = idle - spans.idle_within(
            p, [s for s in named if s not in roots])
        tops = {}
        for n, s, d in p.host:
            if n.startswith(spans.PREFIX):
                tops.setdefault(n[len(spans.PREFIX):], []).append((s, s + d))
        acct["idle_in_s"] = {n: spans.idle_within(p, iv)
                             for n, iv in sorted(tops.items())}
        acct["wall_ms_per_unit"] = {
            n: sum(e - s for s, e in iv) / 1e3 / len(roots)
            for n, iv in sorted(tops.items())}
        acct["count_per_unit"] = {n: len(iv) / len(roots)
                                  for n, iv in sorted(tops.items())}
    os.makedirs(OUT, exist_ok=True)
    name = f"{acct['tree'].replace('/', '_')}.{args.cell}.{args.seed}"
    with gzip.open(os.path.join(OUT, f"{name}.json.gz"), "wt") as f:
        json.dump({"t0": p.t0, "t1": p.t1, "kernels": p.kernels,
                   "spans": [h for h in p.host
                             if h[0].startswith(spans.PREFIX)]}, f)
    return acct


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=("sync", "cost", "trace"))
    ap.add_argument("--cell", default="mvtod.serve")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    out = {"sync": sync, "cost": cost, "trace": trace_run}[args.mode](args)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
