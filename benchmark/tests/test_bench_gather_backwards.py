"""``train.gather_backwards_per_step`` on hand-built probes: the brick
gathers' backward spans inside each step over the steps, and None where
the probe holds no such span (the program before those backwards) or no
step."""

import pytest

from benchmark import harness, spans, trace

P = spans.PREFIX
READER = harness.reader("train.gather_backwards_per_step")


class FakeRun:
    def __init__(self, p):
        self.probe = p


def probe(host):
    return trace.Probe([("k", 0.0, 5.0)],
                       [(P + n, s, e - s) for n, s, e in host], 0.0, 1000.0,
                       [0])


STEPS = [("train.step", 0, 400), ("train.step", 500, 900)]


def test_counts_spans_inside_steps():
    # 3 in the first step, 2 in the second; one outside both
    host = STEPS + [("bricks.gather_backward", s, s + 5)
                    for s in (100, 200, 300, 600, 700, 950)]
    assert READER.read(FakeRun(probe(host))) == pytest.approx(2.5)


@pytest.mark.parametrize("host", [STEPS, [("bricks.gather_backward", 1, 2)]],
                         ids=["no_span", "no_step"])
def test_none_without_spans_or_steps(host):
    assert READER.read(FakeRun(probe(host))) is None
