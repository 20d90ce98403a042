"""The card's idle time after the step's blocking reads: summed over the
``dropclip.sync.*`` spans of the traced window, the idle time from a
span's end to the start of the next kernel (a read drains the stream's
queue, so the card waits for the host to enqueue again), over the
window's wall time. In percent."""

from benchmark import spans


def read(run):
    if spans.units(run.probe, "train.step") is None:
        return None
    reads = spans.named(run.probe, lambda n: n.startswith(spans.SYNC))
    return 100.0 * spans.idle_after(run.probe, reads) / run.probe.window_s
