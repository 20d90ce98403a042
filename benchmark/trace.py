"""A traced sub-window: ``torch.profiler`` over a few units of the
window's own work, reduced to what the per-layer readers take.

The reduction (device intervals, their union, idle gaps named by the
innermost host op that spans them) follows the port's
``core/xplane.py`` reading of Chrome traces, done here on the
profiler's events in memory, so nothing is written to disk."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

_NAME = 120  # characters of a kernel name kept in the breakdown


def _union(intervals: List[tuple]) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _gaps(intervals: List[tuple], lo: float, hi: float) -> List[tuple]:
    gaps, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    return gaps


class Probe:
    """What one profiled session saw: device kernels (name, start us,
    duration us), host ops (name, start us, duration us), the session's
    wall seconds, and what each of its calls returned (``units``)."""

    def __init__(self, kernels, host, t0, t1, units):
        self.kernels, self.host = kernels, host
        self.window_s = (t1 - t0) / 1e6
        self.units = units
        self.t0, self.t1 = t0, t1

    def busy_s(self) -> float:
        return _union([(s, s + d) for _, s, d in self.kernels]) / 1e6

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        return sum(d for n, _, d in self.kernels if match(n)) / 1e6

    def count(self, match: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.kernels if match(n))

    def breakdown(self) -> Dict:
        """The device ops that took most time, and the idle gaps summed
        by the innermost host op that spans each (the 300 longest)."""
        import numpy as np

        ops: Dict[str, float] = {}
        for n, _, d in self.kernels:
            ops[n[:_NAME]] = ops.get(n[:_NAME], 0.0) + d / 1e6
        gaps = sorted(_gaps([(s, s + d) for _, s, d in self.kernels],
                            self.t0, self.t1), key=lambda g: g[0] - g[1])
        start = np.array([h[1] for h in self.host], np.float64)
        dur = np.array([h[2] for h in self.host], np.float64)
        idle: Dict[str, float] = {}
        for s, e in gaps[:300]:
            mid = (s + e) / 2
            inside = np.nonzero((start <= mid) & (start + dur >= mid))[0]
            name = (self.host[inside[np.argmin(dur[inside])]][0]
                    if len(inside) else "host")[:_NAME]
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e6

        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def profile(unit: Callable[[], object], n: int) -> Probe:
    """``n`` calls of ``unit`` under torch.profiler, the card synchronised
    at both ends; what the calls return is the probe's ``units``. Raises
    where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.window"):
            units = [unit() for _ in range(n)]
            torch.cuda.synchronize()
    kernels, host, mark = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # a span's shadow on the device is no device work
            if not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, tr.start, tr.end - tr.start))
        elif e.name == "bench.window":
            mark = (tr.start, tr.end)
        else:
            host.append((e.name, tr.start, tr.end - tr.start))
    if mark is None or not kernels:
        raise RuntimeError("the profiler saw no device time in the traced "
                           "window")
    return Probe(kernels, host, mark[0], mark[1], units)


def counted_profile(unit: Callable[[], object], n: int,
                    launches: Callable[[], int],
                    match: Callable[[str], bool]) -> Probe:
    """``profile``, held to the program's own launch counter: where the
    profiler's count of the kernels ``match`` finds differs from the
    counter's, the session is taken again over twice as many units, and
    a second disagreement raises rather than report a short count."""
    for attempt in range(2):
        before = launches()
        probe = profile(unit, n * 2 ** attempt)
        want, seen = launches() - before, probe.count(match)
        if want == seen:
            return probe
        print(f"traced window: the profiler saw {seen} of {want} counted "
              "launches", flush=True)
    raise RuntimeError(f"the profiler saw {seen} of {want} counted launches "
                       "twice running")
