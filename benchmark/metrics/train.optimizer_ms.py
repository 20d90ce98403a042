"""The optimizer's host time: the mean per optimizer step
(``dropclip.train.step`` span) of the wall of its
``dropclip.train.optimizer`` span (``AmsgradChain.update``: the global
norm, the clip and the moments of every leaf), in the traced steps. In
ms."""

from benchmark import spans


def read(run):
    return spans.mean_wall_ms(run.probe, "train.step", "train.optimizer")
