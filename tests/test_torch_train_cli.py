"""The port's trainer CLI (``python -m dropclip_tpu_torch.tools.
train_distil``) on the CPU: the canonical config with the tiny arch on a
fake .npz dataset, one epoch with a checkpoint, then a resumed run at the
next epoch; grounding eval and the visualization dump with a CLIP
checkpoint file; options that wait for later slices raise."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dropclip_tpu_torch.core.checkpoint import restore_checkpoint
from dropclip_tpu_torch.data.synthetic import write_fake_processed_dataset
from dropclip_tpu_torch.tools import train_distil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "DistilBlender.yaml")


def _opts(data, save, epochs, *extra):
    return ["--config", YAML, "--device", "cpu", "--opts",
            "root_dir", data, "arch_3d", "tiny", "feat_dim", "16",
            "voxel_capacity", "256", "voxel_size", "0.02", "batch_size", "2",
            "batch_size_val", "2", "workers", "2", "workers_val", "1",
            "epochs", str(epochs), "save_path", save, "print_freq", "1",
            *extra]


def test_train_cli_one_epoch_then_resume(tmp_path):
    """Epoch 0 (2 steps, autotuned capacities, eval, checkpoint as
    last_model and best_sim_loss_model), then a second process resumes it
    and trains epoch 1 only: step count and optimizer count carry on."""
    data, save = str(tmp_path / "data"), str(tmp_path / "exp")
    write_fake_processed_dataset(data, n_scenes=4, n_objects=2, feat_dim=16,
                                 fmt="npz")
    first = train_distil.main(_opts(data, save, 1))
    ck = restore_checkpoint(first)
    assert sorted(os.listdir(first)) == ["best_sim_loss_model.pt",
                                         "last_model.pt", "train.log"]
    assert (ck["epoch"], ck["step"], ck["opt_state"]["count"]) == (0, 2, 2)
    assert all(torch.isfinite(v).all() for v in ck["model"].values())
    proc = subprocess.run(
        [sys.executable, "-m", "dropclip_tpu_torch.tools.train_distil",
         *_opts(data, str(tmp_path / "exp2"), 2, "resume", first)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"resumed from {first} @ epoch 1" in proc.stderr
    assert "Epoch [0]" not in proc.stderr and "Epoch [1]" in proc.stderr
    second = proc.stderr.split("checkpoints in ")[-1].strip()
    ck2 = restore_checkpoint(second)
    assert (ck2["epoch"], ck2["step"], ck2["opt_state"]["count"]) == (1, 4, 4)
    assert ck2["best_val"] <= ck["best_val"]


@pytest.mark.parametrize("key,value", [
    ("scan_epochs", "2"), ("clip_checkpoint", "random"),
    ("profile_dir", "/nonexistent"), ("visualize", "True")])
def test_train_cli_refuses_unported_options(tmp_path, monkeypatch, key,
                                            value):
    """Each raises NotImplementedError naming its ROADMAP item, before
    any data is read: scan_epochs and profile_dir on their own; grounding
    eval (clip_checkpoint) and the visualization dump (visualize), which
    run in one process, in several (WORLD_SIZE=2)."""
    if key in ("clip_checkpoint", "visualize"):
        monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_distil.main(_opts(str(tmp_path), str(tmp_path), 1, key,
                                value))


def test_train_cli_evaluates_with_a_clip_checkpoint(tmp_path):
    """clip_checkpoint a CLIP checkpoint file (synthesised, tiny-test):
    the epoch logs Eval Grounding with finite metrics, whose DistilLoss is
    the best checkpoint's; visualize dumps the val scene."""
    import re

    from dropclip_tpu_torch.teachers.convert import \
        synthetic_openai_state_dict

    data, clip = str(tmp_path / "data"), str(tmp_path / "clip.pt")
    write_fake_processed_dataset(data, n_scenes=4, n_objects=2, feat_dim=16,
                                 fmt="npz")
    torch.save(synthetic_openai_state_dict("tiny-test", seed=4), clip)
    save = train_distil.main(_opts(
        data, str(tmp_path / "exp"), 1, "clip_model", "tiny-test",
        "clip_checkpoint", clip, "eval_task", "grounding", "visualize",
        "True"))
    with open(os.path.join(save, "train.log")) as f:
        log = f.read()
    evals = re.findall(r"Eval Grounding: Epoch=\[(\d)/1\] (\{.*\})", log)
    assert [e for e, _ in evals] == ["0"]
    for _, res in evals:
        res = eval(res)
        assert set(res) == {"mIoU", "Pr@25", "Pr@50", "Pr@75", "DistilLoss"}
        assert all(np.isfinite(v) for v in res.values())
    losses = [eval(r)["DistilLoss"] for _, r in evals]
    assert restore_checkpoint(save)["best_val"] == pytest.approx(min(losses))
    vis = os.path.join(save, "vis", "epoch-0", "rank-0")
    assert sorted(os.listdir(vis)) == ["outputs.npz", "outputs.pcd"]
    with np.load(os.path.join(vis, "outputs.npz")) as z:
        assert z["outputs"].shape == z["targets"].shape
        assert z["outputs"].shape[1] == 16
