"""The port's spans (``core/spans.py``) on the serve call and the train
step, read back from ``torch.profiler`` sessions on the CPU at the tiny
sizes: the names and their nesting under each unit's root, the exact
count of blocking reads (``sync.*`` spans) a unit makes, outputs equal
with and without a session, no profiler op with the profiler off, and
``core/xplane``'s span table. (``tests/test_torch_export.py`` holds the
exported serve program to no profiler op.) The text features come from a
fixed table: the text tower is not on these paths' spans.

One test is marked ``cuda``: on the card, the spans and the device
events share one clock. This file imports neither jax nor the JAX
package, so it also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_spans.py
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dropclip_tpu_torch.core import spans as spans_mod
from dropclip_tpu_torch.core import xplane
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.core.spans import PREFIX, span
from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
from dropclip_tpu_torch.distill.engine import (DistilBatch, build_student_for,
                                               make_train_step)
from dropclip_tpu_torch.distill.train_state import (create_train_state,
                                                    make_optimizer)
from dropclip_tpu_torch.pipeline import GroundingPipeline

CFG = dict(arch_3d="tiny", feat_dim=16, voxel_capacity=128, voxel_size=0.05,
           use_color=True, sparse_backend="bricks", brick_shape=[4, 4, 2],
           sim_method="paired", sim_norm_thresh=0.6, batch_size=2,
           base_lr=3e-4, min_lr=1e-4, epochs=2, max_norm=5.0,
           weight_decay=1e-5, loss_type="cosine")
QUERIES = ["the red mug", "a bowl"]
NEGATIVES = ["object", "thing"]

# the blocking reads of one unit, as PERF.md states them: serve, the
# four uploads (coords, mask, features, the voxel mask for grounding),
# the grid's two numbers, the dropped count and the two read-backs;
# train, the grid's two numbers, one row count per k3 conv's weight
# gradient (16 in the tiny student, as in MinkUNet14D) and the
# optimizer's step count copied to the device
SERVE_READS = {"sync.upload": 4, "sync.grid_bits": 2, "sync.dropped": 1,
               "sync.readback": 2}
TRAIN_READS = {"sync.grid_bits": 2, "sync.wgrad_rows": 16, "sync.count": 1}
SERVE_SPANS = {"serve.voxelize", "topology", "student", "serve.text",
               "serve.ground", "serve.to_points"}
TRAIN_SPANS = {"topology", "student", "train.backward", "train.optimizer"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def clouds(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xyz = rng.uniform(-0.2, 0.2, (60, 3)).astype(np.float32)
        out.append((xyz, rng.uniform(0, 1, (60, 3)).astype(np.float32)))
    return out


class FixedText:
    """``ClipSimilarity``'s cache, filled: a unit feature per prompt."""

    def __init__(self, device):
        prompts = QUERIES + NEGATIVES
        f = torch.randn(len(prompts), 16,
                        generator=torch.Generator().manual_seed(6))
        f = (f / f.norm(dim=-1, keepdim=True)).to(device)
        self.table = {p: f[i] for i, p in enumerate(prompts)}

    def encode_text(self, prompts):
        return torch.stack([self.table[p] for p in prompts])


def make_pipe(device="cpu"):
    return GroundingPipeline(CfgNode(dict(CFG)), clip_sim=FixedText(device),
                             device=device, seed=1)


@pytest.fixture(scope="module")
def pipe():
    return make_pipe()


def make_trainer(device="cpu"):
    cfg = CfgNode(dict(CFG))
    model = build_student_for(cfg, generator=torch.Generator().manual_seed(2))
    state = create_train_state(model.to(device), make_optimizer(cfg, 10))
    coords, mask = make_tabletop_coords(np.random.RandomState(3), 2, 128,
                                        n_occ=60, ext=8, n_blobs=2)
    rng = np.random.RandomState(4)
    feats = (rng.randn(2, 128, 6) * mask[..., None]).astype(np.float32)
    tgt = rng.randn(2, 128, 16).astype(np.float32)
    tgt /= np.linalg.norm(tgt, axis=-1, keepdims=True)
    z = np.zeros((2, 128), np.int32)
    batch = DistilBatch(*(torch.as_tensor(a, device=device) for a in (
        coords, mask, feats, tgt * mask[..., None], z, z)))
    return state, make_train_step(cfg), batch


def recorded(fn, activities=(ProfilerActivity.CPU,)):
    """(what ``fn`` returns, [(name less the prefix, start, end)] of the
    session's ``dropclip.*`` spans)."""
    with profile(activities=list(activities)) as prof:
        out = fn()
    # the session's raw events: FunctionEvents of every op take seconds
    found = sorted((e.name()[len(PREFIX):], e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(PREFIX)
                   and e.device_type() == torch.autograd.DeviceType.CPU)
    return out, found


def check_unit(found, root, names, reads):
    roots = [s for s in found if s[0] == root]
    assert len(roots) == 1, found
    _, s0, e0 = roots[0]
    rest = [s for s in found if s[0] != root]
    assert all(s >= s0 and e <= e0 for _, s, e in rest), found
    assert names <= {n for n, _, _ in rest}
    counts = {}
    for n, _, _ in rest:
        if n.startswith("sync."):
            counts[n] = counts.get(n, 0) + 1
    assert counts == reads


def call_batch(pipe):
    c = clouds(2)
    return pipe.ground_batch([x for x, _ in c], [r for _, r in c], QUERIES,
                             negatives=NEGATIVES)


def call_one(pipe):
    xyz, rgb = clouds(1, seed=5)[0]
    return pipe.ground(xyz, rgb, QUERIES, negatives=NEGATIVES)


@pytest.mark.parametrize("call", [call_batch, call_one],
                         ids=["ground_batch", "ground"])
def test_serve_call_records_its_spans_and_reads(pipe, call):
    call(pipe)  # the text cache filled, as in a grounding job
    _, found = recorded(lambda: call(pipe))
    check_unit(found, "serve.call", SERVE_SPANS, SERVE_READS)


def test_train_step_records_its_spans_and_reads():
    state, step, batch = make_trainer()
    _, found = recorded(lambda: step(state, batch))
    check_unit(found, "train.step", TRAIN_SPANS, TRAIN_READS)
    # the row counts are read inside the backward that waits for them
    back = [s for s in found if s[0] == "train.backward"][0]
    for n, s, e in found:
        if n == "sync.wgrad_rows":
            assert back[1] <= s and e <= back[2]


def test_train_step_holds_one_gather_backward_span_per_gather():
    """The brick engine's gathers (4 down convs, 4 up convs, the points)
    each run one backward span, inside ``train.backward``."""
    state, step, batch = make_trainer()
    _, found = recorded(lambda: step(state, batch))
    back = [s for s in found if s[0] == "train.backward"][0]
    gathers = [s for s in found if s[0] == "bricks.gather_backward"]
    assert len(gathers) == 9
    assert all(back[1] <= s and e <= back[2] for _, s, e in gathers)


def test_outputs_equal_with_and_without_a_session(pipe):
    off = call_batch(pipe)
    on, _ = recorded(lambda: call_batch(pipe))
    for a, b in zip(off[0] + [off[1]], on[0] + [on[1]]):
        assert np.array_equal(a, b)
    steps = []
    for session in (False, True):
        state, step, batch = make_trainer()
        run = (lambda: step(state, batch)) if not session else \
            (lambda: recorded(lambda: step(state, batch))[0])
        _, metrics = run()
        steps.append((metrics, [p.detach().clone()
                                for p in state.model.parameters()]))
    (m0, p0), (m1, p1) = steps
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_no_session_enters_no_record_function(pipe, monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name!r} entered record_function")

    monkeypatch.setattr(spans_mod, "_On", refuse)
    assert span("serve.call") is span("serve.call")
    call_batch(pipe)
    call_one(pipe)
    state, step, batch = make_trainer()
    step(state, batch)
    with pytest.raises(AssertionError, match="entered record_function"):
        recorded(lambda: call_one(pipe))


def test_span_table_of_a_chrome_trace(pipe, tmp_path):
    call_batch(pipe)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call_batch(pipe)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    totals = xplane.span_totals(path)
    assert totals["serve.call"][0] == 1
    assert totals["sync.readback"][0] == 2
    n, wall, own = totals["serve.call"]
    children = sum(totals[k][1] for k in SERVE_SPANS | {"sync.upload",
                                                        "sync.dropped",
                                                        "sync.readback"})
    # the grid's reads nest inside the topology, counted there
    assert own == pytest.approx(wall - children, abs=2e-5)
    for name, (n, wall, own) in totals.items():
        assert 0 <= own <= wall + 1e-9
    assert "serve.call" in xplane.format_profile(path)


def test_span_table_self_time_of_nested_spans(tmp_path):
    """Hand-made spans: a root of 100 us holding two children (30 and
    20 us, one of which holds a 10 us read) has 50 us of self time."""
    ev = [dict(ph="X", cat="user_annotation", name=PREFIX + n, ts=ts,
               dur=d, pid=1, tid=t) for n, ts, d, t in (
        ("root", 0.0, 100.0, 1), ("a", 10.0, 30.0, 1),
        ("b", 50.0, 20.0, 2), ("sync.x", 55.0, 10.0, 2))]
    ev.append(dict(ph="X", cat="cpu_op", name="aten::add", ts=5.0, dur=1.0,
                   pid=1, tid=1))
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    totals = xplane.span_totals(str(path))
    assert totals["root"] == (1, pytest.approx(1e-4), pytest.approx(5e-5))
    assert totals["b"] == (1, pytest.approx(2e-5), pytest.approx(1e-5))
    assert set(totals) == {"root", "a", "b", "sync.x"}


# how far the profiler's device timestamps may sit from its host clock:
# in some sessions every kernel reads up to 0.28 ms before its own launch
# (the profiler's alignment of the two clocks, not the spans'); a span on
# another clock would be off by far more
CLOCK_SLACK_US = 1000.0


@pytest.mark.cuda
def test_spans_share_the_device_events_clock(tmp_path):
    """On the card: every kernel launched inside a ``student`` span starts
    no earlier than the span, and every ``sync.readback`` span ends no
    earlier than the last kernel launched before it, both within the
    profiler's own alignment of device and host time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the device events' clock")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = make_pipe("cuda")
    call_batch(p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call_batch(p)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = {e["args"]["correlation"]: e for e in ev
              if e.get("cat") in xplane.DEVICE_CATEGORIES
              and "correlation" in e.get("args", {})}
    launches = sorted((e["ts"], device[e["args"]["correlation"]])
                      for e in ev if e.get("cat") in ("cuda_runtime",
                                                      "cuda_driver")
                      and e.get("args", {}).get("correlation") in device)
    assert launches, "the profiler saw no device event"

    def spans_named(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in ev
                if e.get("cat") == "user_annotation"
                and e["name"] == PREFIX + name]

    student = spans_named("student")
    assert len(student) == 3
    seen = 0
    for s, e in student:
        for ts, k in launches:
            if s <= ts <= e:
                seen += 1
                assert k["ts"] >= s - CLOCK_SLACK_US, (k["name"], k["ts"], s)
    assert seen >= 3 * 16
    reads = spans_named("sync.readback")
    assert len(reads) == 6
    for s, e in reads:
        before = [k for ts, k in launches if ts < s]
        last = before[-1]
        assert last["ts"] + last["dur"] <= e + CLOCK_SLACK_US, \
            (last["name"], e)
