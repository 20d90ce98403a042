"""Backwards of the brick engine's row gathers per optimizer step: the
program's ``dropclip.bricks.gather_backward`` spans (one a down conv's,
an up conv's or the points' gather whose backward reads through the
topology's inverse maps) inside the traced ``dropclip.train.step`` spans,
over their number. An exact count; None where the program has no such
span."""

from benchmark import spans


def read(run):
    steps = spans.units(run.probe, "train.step")
    if steps is None:
        return None
    found = spans.named(run.probe, "bricks.gather_backward")
    if not found:
        return None
    return sum(len(spans.inside(found, u)) for u in steps) / len(steps)
