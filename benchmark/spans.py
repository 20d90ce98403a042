"""The program's spans in a traced sub-window (``trace.Probe``), reduced
to what the span readers of ``benchmark/metrics/`` take.

The program names its spans ``dropclip.<name>`` (``record_function``),
so they land among the probe's host events on the profiler's clock, the
clock of its device events. A unit is one root span (``serve.call``, a
``ground_batch`` call; ``train.step``, an optimizer step); a span belongs
to the unit whose interval holds it, on any thread (a read on autograd's
thread lies inside the step that waits for it). ``sync.<site>`` spans
wrap the program's blocking reads of the card, one span a read. Every
function returns None where the probe holds no root span, as the
parent of the change that added the spans does."""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

PREFIX = "dropclip."
SYNC = "sync."

Interval = Tuple[float, float]


def named(probe, match) -> List[Interval]:
    """Start and end (us) of every span whose name, less the prefix,
    ``match`` takes: a name, or a predicate."""
    test = match if callable(match) else (lambda n: n == match)
    return sorted((s, s + d) for n, s, d in probe.host
                  if n.startswith(PREFIX) and test(n[len(PREFIX):]))


def union(intervals: List[Interval]) -> List[Interval]:
    """The disjoint intervals that cover ``intervals``, in order."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def inside(spans: List[Interval], unit: Interval) -> List[Interval]:
    return [(s, e) for s, e in spans if s >= unit[0] and e <= unit[1]]


def units(probe, root: str) -> Optional[List[Interval]]:
    """The root spans of the probe, or None (no probe, no root span)."""
    if probe is None:
        return None
    roots = named(probe, root)
    return roots or None


def mean_wall_ms(probe, root: str, child: str) -> Optional[float]:
    """The mean over units of the wall (ms) that ``child`` spans cover
    inside the unit, their union (a nested span counted once)."""
    roots = units(probe, root)
    if roots is None:
        return None
    spans = named(probe, child)
    total = sum(e - s for u in roots for s, e in union(inside(spans, u)))
    return total / len(roots) / 1e3


def reads_per_unit(probe, root: str) -> Optional[float]:
    """``sync.*`` spans inside units, over the units."""
    roots = units(probe, root)
    if roots is None:
        return None
    reads = named(probe, lambda n: n.startswith(SYNC))
    return sum(len(inside(reads, u)) for u in roots) / len(roots)


def idle_within(probe, intervals: List[Interval]) -> float:
    """Seconds of the card's idle time inside ``intervals`` (their union,
    clipped to the traced window): the intervals' length less the kernel,
    copy and fill time that overlaps them."""
    cover = union([(max(s, probe.t0), min(e, probe.t1))
                   for s, e in intervals if min(e, probe.t1)
                   > max(s, probe.t0)])
    busy = union([(s, s + d) for _, s, d in probe.kernels])
    starts = [s for s, _ in busy]
    idle = 0.0
    for s, e in cover:
        idle += e - s
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        for bs, be in busy[i:]:
            if bs >= e:
                break
            idle -= max(0.0, min(be, e) - max(bs, s))
    return idle / 1e6


def idle_after(probe, spans: List[Interval]) -> float:
    """Seconds of the card's idle time from the end of each span to the
    start of the first kernel that starts at or after it (the end of the
    window where none does), the intervals taken once where they
    overlap."""
    starts = sorted(s for _, s, _ in probe.kernels)
    gaps = []
    for _, e in spans:
        i = bisect.bisect_left(starts, e)
        gaps.append((e, starts[i] if i < len(starts) else probe.t1))
    return idle_within(probe, gaps)
