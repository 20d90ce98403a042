"""The 95th percentile of the host wall time of every ``ground_batch``
call of the traced run's measured window, from the call to its masks in
host numpy, over all calls (some 240 in 30 seconds). A per-layer metric:
the card idles most of a call (``serve.idle_share``), so the host paces
it and the tail swings with the host."""


def read(run):
    return run.work.get("call_p95_ms")
