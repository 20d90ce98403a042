"""Blocking reads of the card per ``ground_batch`` call: the program's
``dropclip.sync.*`` spans (one a read: a value read back, or a copy from
pageable host memory, which waits for the stream) inside the traced
``dropclip.serve.call`` spans, over their number. An exact count."""

from benchmark import spans


def read(run):
    return spans.reads_per_unit(run.probe, "serve.call")
