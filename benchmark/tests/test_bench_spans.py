"""The span readers (``benchmark/spans.py`` and the eight metrics that
read the program's ``dropclip.*`` spans) on hand-built probes whose
intervals give each number by hand, and None where the probe holds no
root span, as the program before the spans does."""

import pytest

from benchmark import harness, spans, trace

P = spans.PREFIX


def probe(kernels, host):
    return trace.Probe([("k", s, e - s) for s, e in kernels],
                       [(P + n, s, e - s) for n, s, e in host]
                       + [("aten::add", 1.0, 2.0)], 0.0, 1000.0, [0, 1])


# two calls in a window of 1000 us; the nested voxelize span counts once
SERVE = probe(
    [(0, 50), (200, 300), (520, 530), (860, 870)],
    [("serve.call", 0, 400), ("serve.voxelize", 10, 110),
     ("serve.voxelize", 20, 30), ("sync.grid_bits", 120, 125),
     ("sync.grid_bits", 126, 130), ("serve.ground", 250, 290),
     ("sync.dropped", 300, 310), ("sync.readback", 320, 330),
     ("sync.readback", 331, 340), ("serve.to_points", 350, 390),
     ("serve.call", 500, 900), ("serve.voxelize", 510, 570),
     ("serve.ground", 700, 720), ("sync.readback", 800, 810),
     ("serve.to_points", 850, 880)])

# two steps; the grid's reads lie inside the topology span
TRAIN = probe(
    [(0, 20), (40, 190), (230, 400), (520, 690), (725, 900)],
    [("train.step", 0, 450), ("topology", 10, 60),
     ("sync.grid_bits", 20, 25), ("sync.grid_bits", 26, 30),
     ("sync.wgrad_rows", 200, 210), ("train.optimizer", 400, 440),
     ("train.step", 500, 950), ("topology", 510, 540),
     ("sync.wgrad_rows", 700, 705), ("sync.wgrad_rows", 710, 715),
     ("train.optimizer", 900, 930)])

# metric -> (probe, value): worked out from the intervals above
EXPECTED = {
    # (100 + 60) / 2 us
    "serve.prep_ms": (SERVE, 0.080),
    # (40 + 20) / 2 us
    "serve.ground_ms": (SERVE, 0.030),
    # (5 + 1) / 2
    "serve.host_reads_per_call": (SERVE, 3.0),
    # idle in voxelize and to_points: 60 + 40 + 50 + 20 us of 1000
    "serve.prep_idle_share": (SERVE, 17.0),
    # (50 + 30) / 2 us
    "train.topology_ms": (TRAIN, 0.040),
    # (40 + 30) / 2 us
    "train.optimizer_ms": (TRAIN, 0.035),
    # (3 + 2) / 2
    "train.host_reads_per_step": (TRAIN, 2.5),
    # idle from each read to the next kernel, overlaps once: 15 + 20 +
    # 20 us of 1000
    "train.sync_idle_share": (TRAIN, 5.5),
}


class FakeRun:
    def __init__(self, p):
        self.probe = p


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_known_intervals(name):
    p, want = EXPECTED[name]
    assert harness.reader(name).read(FakeRun(p)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_probe_or_root_span_gives_none(name):
    reader = harness.reader(name)
    assert reader.read(FakeRun(None)) is None
    bare = trace.Probe([("k", 0.0, 5.0)], [("aten::item", 4.0, 7.0)], 0.0,
                       20.0, [0])
    assert reader.read(FakeRun(bare)) is None
    # the other path's root only
    other = TRAIN if name.startswith("serve.") else SERVE
    assert reader.read(FakeRun(other)) is None


def test_every_span_metric_is_declared():
    spec = harness.spec_of()
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name in EXPECTED:
        m = declared[name]
        assert m["source"] == "device_trace" and m["better"] == "lower"
        cells = {"serve": ["mvtod.serve"],
                 "train": ["mvtod.train", "regrad.train"]}
        assert m["workloads"] == cells[name.split(".")[0]]


def test_idle_within_clips_to_the_window_and_merges():
    p = probe([(10, 20), (15, 30)], [])
    assert spans.idle_within(p, [(-50, 40), (35, 45)]) == pytest.approx(
        (45 - 20) * 1e-6)
    assert spans.idle_after(p, [(0, 5), (0, 950)]) == pytest.approx(
        (10 - 5 + 1000 - 950) * 1e-6)
