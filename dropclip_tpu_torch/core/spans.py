"""Named spans on ``torch.profiler``, the profiler the repo already uses.

    from dropclip_tpu_torch.core.spans import span

    with span("topology"):
        topo = build_topology(...)

    @span("serve.call")
    def ground_batch(...): ...

With no profiler session active, ``span(name)`` costs one flag check and
returns a no-op context: it dispatches no op and allocates nothing (the
no-op of each name is made once, at its first use). Inside a session it
enters ``torch.profiler.record_function("dropclip." + name)``, so the span
lands in every session that is open: the benchmark's traced window,
``train_distil``'s ``profile_dir`` and ``tools/profile.py``, on the
profiler's clock, which is that of the device events. Nothing is kept or
exported here; ``core/xplane.span_totals`` reads the spans of a Chrome
trace. No span is entered while the current stream captures a CUDA graph.

A span named ``sync.<site>`` wraps one blocking read of the device (a
host read of a value, or a copy from pageable host memory, which waits
for the stream): its duration is the host's wait, and the number of
``sync.*`` spans in a unit is its count of reads.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

PREFIX = "dropclip."

_profiling = torch._C._autograd._profiler_enabled


class _NoOp:
    """A span's context with the profiler off; as a decorator it wraps a
    function so that each call enters ``span(name)``."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


# one no-op context per span name, made at the name's first use
_NOOPS: Dict[str, _NoOp] = {}


class _On(torch.profiler.record_function):
    """``record_function`` under the span's prefixed name, also usable as
    a decorator that names the span, not the record."""

    def __init__(self, name: str):
        super().__init__(PREFIX + name)
        self.span_name = name

    def __call__(self, fn):
        return _NoOp(self.span_name)(fn)


def span(name: str):
    """The span ``dropclip.<name>``: a context manager, or a decorator of
    a function each call of which is the span. A no-op unless a
    ``torch.profiler`` session is recording."""
    if not _profiling() or (torch.cuda.is_initialized() and
                            torch.cuda.is_current_stream_capturing()):
        return _NOOPS.get(name) or _NOOPS.setdefault(name, _NoOp(name))
    return _On(name)
