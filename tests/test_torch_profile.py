"""The profiling tools on the CPU: ``tools/profile.py --tiny --device
cpu`` on each surface, ``core/xplane.py`` on ``torch.profiler`` traces
(device kernels when the trace has them, the CPU ops' self time when it
does not), ``stem_totals`` and ``env_flag`` against the JAX package's,
and the trainer's ``profile_dir``."""

import json
import os

import pytest
import torch

from dropclip_tpu.core import platform as jplatform
from dropclip_tpu.core import xplane as jxplane
from dropclip_tpu_torch.core import platform, xplane
from dropclip_tpu_torch.core.checkpoint import restore_checkpoint
from dropclip_tpu_torch.data.synthetic import write_fake_processed_dataset
from dropclip_tpu_torch.tools import profile as profile_cli
from dropclip_tpu_torch.tools import train_distil


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """This file's torch ops in two threads: the tier-1 run shares the
    box's cores among several test processes, where more threads only
    wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("surface", ["train", "infer", "teacher", "fusion"])
def test_profile_cli_tiny_on_the_cpu(tmp_path, capsys, surface):
    """Each surface at its tiny shapes: a trace under ``--logdir`` and a
    table read from the CPU ops (no device events), its rows positive;
    the train and infer tables name K1's registered op."""
    logdir = str(tmp_path / "prof")
    assert profile_cli.main(["--surface", surface, "--tiny", "--device",
                             "cpu", "--logdir", logdir, "--reps", "1",
                             "--top", "40"]) == 0
    text = capsys.readouterr().out
    assert os.listdir(logdir) == ["trace.json"]
    assert xplane.HOST_SOURCE in text
    totals, source = xplane.read_totals(logdir)
    assert source == xplane.HOST_SOURCE and all(
        v >= 0 for v in totals.values()) and sum(totals.values()) > 0
    if surface in ("train", "infer"):
        assert "dropclip::brick_conv3" in text.split("stems:")[0]


def test_op_totals_self_time_of_a_cpu_trace(tmp_path):
    """On a real ``torch.profiler`` trace of CPU ops: every op's self
    time is at most its total, the self times sum to no more than the
    wall of the traced work, and ``aten::linear``'s self time leaves out
    the product it calls."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(512, 512)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.nn.functional.linear(a, a).relu().sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    totals, source = xplane.read_totals(str(tmp_path))
    assert source == xplane.HOST_SOURCE
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "cpu_op"]
    whole = {}
    for e in events:
        whole[e["name"]] = whole.get(e["name"], 0.0) + e["dur"] / 1e6
    assert all(totals[k] <= whole[k] + 1e-9 for k in totals)
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events)) / 1e6
    assert sum(totals.values()) <= span + 1e-9
    assert totals["aten::linear"] < whole["aten::linear"]


def test_op_totals_reads_device_kernels(tmp_path):
    """A trace with CUDA kernel events (the shape ``torch.profiler``
    writes on the card): the kernels' durations summed by name, device
    copies included, CPU ops ignored, and ``device`` filtering by the
    events' card."""
    ev = [dict(ph="X", cat="cpu_op", name="aten::mm", ts=0, dur=50,
               pid=1, tid=1),
          dict(ph="X", cat="kernel", name="brick_conv3_mma", ts=1, dur=30,
               args={"device": 0}),
          dict(ph="X", cat="kernel", name="brick_conv3_mma", ts=40, dur=12,
               args={"device": 0}),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=60, dur=5,
               args={"device": 0}),
          dict(ph="X", cat="kernel", name="other", ts=70, dur=7,
               args={"device": 1}),
          dict(ph="i", cat="kernel", name="marker", ts=80)]
    with open(tmp_path / "t.json", "w") as f:
        json.dump({"traceEvents": ev}, f)
    totals, source = xplane.read_totals(str(tmp_path))
    assert source == xplane.DEVICE_SOURCE
    assert totals == pytest.approx({"brick_conv3_mma": 42e-6,
                                    "Memcpy HtoD": 5e-6, "other": 7e-6})
    assert xplane.op_totals(str(tmp_path), device=1) == pytest.approx(
        {"other": 7e-6})
    text = xplane.format_profile(str(tmp_path), top=2)
    assert "CUDA kernels" in text and "brick_conv3_mma" in text


def test_stem_totals_match_jax():
    """The same dict of names to seconds gives the JAX function's stems."""
    totals = {"%fusion.123 = f32[8]{0} fusion(...)": 1.5, "fusion.9": 0.5,
              "%convolution.4 = bf16[1,2] convolution(x)": 2.0,
              "brick_conv3_mma": 3.0, "aten::mm": 0.25, "copy.3.1": 1.0}
    assert xplane.stem_totals(totals) == jxplane.stem_totals(totals)


@pytest.mark.parametrize("raw", [None, "", "0", "1", "false", "FALSE",
                                 "no", " off ", "yes", "anything"])
@pytest.mark.parametrize("default", [False, True])
def test_env_flag_matches_jax(monkeypatch, raw, default):
    """``core.platform.env_flag`` equals the JAX package's on the same
    environment value and default."""
    if raw is None:
        monkeypatch.delenv("DROPCLIP_TEST_FLAG", raising=False)
    else:
        monkeypatch.setenv("DROPCLIP_TEST_FLAG", raw)
    assert platform.env_flag("DROPCLIP_TEST_FLAG", default) == \
        jplatform.env_flag("DROPCLIP_TEST_FLAG", default)


def test_profile_dir_writes_a_trace(tmp_path):
    """``train_distil`` with ``profile_dir`` on a tiny run of 15 steps:
    steps 10-14 traced into the directory, the table logged, the run's
    checkpoint written as without it."""
    data, prof = str(tmp_path / "data"), str(tmp_path / "prof")
    write_fake_processed_dataset(data, n_scenes=30, n_objects=2,
                                 feat_dim=16, fmt="npz")
    save = train_distil.main([
        "--config", "configs/DistilBlender.yaml", "--device", "cpu",
        "--opts", "root_dir", data, "arch_3d", "tiny", "feat_dim", "16",
        "voxel_capacity", "256", "voxel_size", "0.02", "batch_size", "2",
        "batch_size_val", "2", "workers", "2", "workers_val", "1",
        "epochs", "1", "save_path", str(tmp_path / "exp"), "evaluate",
        "False", "profile_dir", prof])
    assert restore_checkpoint(save)["step"] == 15
    assert os.listdir(prof) == ["trace.rank-0.json"]
    with open(os.path.join(save, "train.log")) as f:
        log = f.read()
    assert "profiler trace of steps 10-14" in log
    assert "dropclip::brick_conv3" in log
    assert xplane.op_totals(prof)
