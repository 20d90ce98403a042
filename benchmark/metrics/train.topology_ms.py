"""The brick topology's build: the mean per optimizer step
(``dropclip.train.step`` span) of the wall of its ``dropclip.topology``
span (``build_topology``, the grid's two reads included), in the traced
steps. In ms."""

from benchmark import spans


def read(run):
    return spans.mean_wall_ms(run.probe, "train.step", "topology")
