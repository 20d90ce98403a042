"""Per-op totals from a ``torch.profiler`` trace.

Port of ``dropclip_tpu/core/xplane.py``. The name stays so that a reader
finds the counterpart, but nothing here reads an xplane: the input is the
Chrome trace that ``torch.profiler.profile.export_chrome_trace`` writes
(a ``*.json`` file, or ``*.json.gz``). Typical use::

    with torch.profiler.profile(activities=[...]) as prof:
        step(...)
        torch.cuda.synchronize()            # sync INSIDE the trace
    prof.export_chrome_trace(f"{logdir}/trace.json")
    totals = op_totals(logdir)              # {kernel name: seconds}

Device totals are the trace's CUDA kernel events (and its device copies
and fills), summed by name; they hold even when the host clock does not.
A CPU run's trace has no device events: there the totals are the CPU
ops' self times (each op's time less its child ops' on the same thread),
as the JAX module falls back to host thunk times: a host-time ranking
only. ``read_totals`` says which of the two it read. ``span_totals``
reads the program's ``dropclip.*`` spans (``core/spans.py``): each
name's count, wall and self time. ``tools/profile.py`` wraps this as a
CLI over the hot surfaces.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Tuple

# device events of a torch.profiler Chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "dropclip."
DEVICE_SOURCE = "CUDA kernels"
HOST_SOURCE = "CPU ops' self time (the trace has no device events)"


def _load_trace(logdir: str) -> List[dict]:
    """The events of the newest Chrome trace under ``logdir`` (or the file
    ``logdir`` itself)."""
    if os.path.isfile(logdir):
        paths = [logdir]
    else:
        paths = sorted(
            glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True)
            + glob.glob(os.path.join(logdir, "**", "*.json.gz"),
                        recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *.json trace under {logdir}")
    path = paths[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X"]


def _host_self_totals(events: List[dict]) -> Dict[str, float]:
    """Per CPU op name, seconds of self time: on each thread an op's
    duration less that of the ops nested directly inside it, so the
    totals partition the time spent in ops."""
    totals: Dict[str, float] = {}
    threads: Dict[tuple, List[dict]] = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            threads.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[list] = []  # [end, name, child time, duration]

        def close(until):
            while stack and stack[-1][0] <= until:
                end, name, child, dur = stack.pop()
                totals[name] = totals.get(name, 0.0) + (dur - child) / 1e6
                if stack:
                    stack[-1][2] += dur

        for e in evs:
            dur = float(e.get("dur", 0))
            close(e["ts"])
            stack.append([e["ts"] + dur, e["name"], 0.0, dur])
        close(float("inf"))
    return totals


def read_totals(logdir: str, device: Optional[int] = None
                ) -> Tuple[Dict[str, float], str]:
    """({op name: seconds}, what was read) from the newest trace: the
    device events of card ``device`` (None: every card), or, in a trace
    with no device event, the CPU ops' self times."""
    events = _load_trace(logdir)
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
           and (device is None
                or e.get("args", {}).get("device") == device)]
    if not dev:
        return _host_self_totals(events), HOST_SOURCE
    totals: Dict[str, float] = {}
    for e in dev:
        totals[e["name"]] = totals.get(e["name"], 0.0) + \
            float(e.get("dur", 0)) / 1e6
    return totals, DEVICE_SOURCE


def span_totals(logdir: str) -> Dict[str, Tuple[int, float, float]]:
    """Per ``dropclip.*`` span of the newest trace, by its name less the
    prefix: (count, wall
    seconds, self seconds). A span's self time is its wall less the union
    of the spans that lie inside it, on any thread (a read on autograd's
    thread lies inside the backward that waits for it)."""
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     e["name"][len(SPAN_PREFIX):]) for e in _load_trace(logdir)
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(SPAN_PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    totals: Dict[str, Tuple[int, float, float]] = {}
    for i, (s, e, name) in enumerate(spans):
        covered, end = 0.0, s
        for cs, ce, _ in spans[i + 1:]:
            if cs > e:
                break
            if ce <= e and ce > end:
                covered += ce - max(cs, end)
                end = ce
        n, wall, own = totals.get(name, (0, 0.0, 0.0))
        totals[name] = (n + 1, wall + (e - s) / 1e6,
                        own + (e - s - covered) / 1e6)
    return totals


def op_totals(logdir: str, device: Optional[int] = None) -> Dict[str, float]:
    """Summed seconds per op name from the newest trace (``read_totals``
    without the source)."""
    return read_totals(logdir, device)[0]


def stem_totals(totals: Dict[str, float]) -> Dict[str, float]:
    """Collapse ``%fusion.123 = ...`` instances to their op stem (the JAX
    function, kept as it is)."""
    stems: Dict[str, float] = {}
    for name, s in totals.items():
        stem = re.sub(r"[.\d]*\s*=.*", "", name).strip()
        stem = re.sub(r"\.\d+$", "", stem)  # CPU thunk names: 'fusion.9'
        stems[stem] = stems.get(stem, 0.0) + s
    return stems


def format_profile(logdir: str, top: int = 25,
                   device: Optional[int] = None) -> str:
    """The per-op table of the newest trace and its stems, as text."""
    totals, source = read_totals(logdir, device)
    tot = sum(totals.values())
    lines = [f"total {tot * 1e3:.2f} ms over {len(totals)} ops ({source})"]
    for name, s in sorted(totals.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {s * 1e3:8.2f} ms  {100 * s / max(tot, 1e-12):5.1f}%"
                     f"  {name[:100]}")
    lines.append("\nstems:")
    for stem, s in sorted(stem_totals(totals).items(),
                          key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {s * 1e3:8.2f} ms  {100 * s / max(tot, 1e-12):5.1f}%"
                     f"  {stem[:90]}")
    spans = span_totals(logdir)
    if spans:
        lines.append(f"\nspans ({SPAN_PREFIX}*): count, wall ms, self ms")
        for name, (n, wall, own) in sorted(spans.items(),
                                           key=lambda kv: -kv[1][1]):
            lines.append(f"  {n:6d}  {wall * 1e3:9.2f}  {own * 1e3:9.2f}"
                         f"  {name}")
    return "\n".join(lines)


def print_profile(logdir: str, top: int = 25,
                  device: Optional[int] = None) -> None:
    print(format_profile(logdir, top, device))
