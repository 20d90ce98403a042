"""Blocking reads of the card per optimizer step: the program's
``dropclip.sync.*`` spans (one a read: the grid's two numbers, each k3
conv's weight-gradient row count, and any other) inside the traced
``dropclip.train.step`` spans, over their number. An exact count."""

from benchmark import spans


def read(run):
    return spans.reads_per_unit(run.probe, "train.step")
