"""``tools/convert_checkpoint`` on the CPU: a tiny student trained a few
steps, written out in MinkowskiEngine's layout under each kernel-offset
order, converted with ``--offset-order auto`` on probe scenes whose
targets that student produced; the right order picked both times, and
the converted checkpoint served by ``GroundingPipeline.from_checkpoint``
with the trained student's weights."""

import json
import os

import numpy as np
import pytest
import torch

from dropclip_tpu_torch.convert import student_trees
from dropclip_tpu_torch.core.checkpoint import restore_checkpoint
from dropclip_tpu_torch.core.config import load_cfg, merge_cfg_from_list
from dropclip_tpu_torch.data.synthetic import (make_tabletop_coords,
                                               write_fake_processed_dataset,
                                               write_student_targets)
from dropclip_tpu_torch.distill import engine
from dropclip_tpu_torch.distill.train_state import (create_train_state,
                                                    make_optimizer)
from dropclip_tpu_torch.pipeline import GroundingPipeline
from dropclip_tpu_torch.sparse.convert_student import to_minkowski_state_dict
from dropclip_tpu_torch.tools import convert_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "DistilBlender.yaml")
OPTS = ["arch_3d", "tiny", "feat_dim", "16", "voxel_capacity", "256",
        "voxel_size", "0.02", "brick_capacities", "[128,64,64,64,64]"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """This file's torch ops in two threads: the tier-1 run shares the
    box's cores among several test processes, where more threads only
    wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trained_student(cfg):
    """The tiny student after three optimizer steps on tabletop batches
    with random targets."""
    net = engine.build_student_for(cfg,
                                   generator=torch.Generator().manual_seed(4))
    state = create_train_state(net, make_optimizer(cfg, 3))
    step = engine.make_train_step(cfg)
    rng = np.random.RandomState(4)
    for _ in range(3):
        coords, mask = make_tabletop_coords(rng, 2, 256, n_occ=180, ext=10)
        m = mask[..., None]
        batch = engine.DistilBatch(*(torch.as_tensor(a) for a in (
            coords, mask, (rng.randn(2, 256, 6) * m).astype(np.float32),
            (rng.randn(2, 256, 16) * m).astype(np.float32),
            np.zeros((2, 256), np.int32), np.zeros((2, 256), np.int32))))
        step(state, batch)
    return net.eval()


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Probe scenes (one-point objects, so nearly every voxel has its own
    target) written with the trained student's outputs as targets, the
    student saved in both ME orders and converted with auto, and once
    with the wrong order forced."""
    tmp = tmp_path_factory.mktemp("convert")
    cfg = merge_cfg_from_list(load_cfg(YAML), list(OPTS))
    net = _trained_student(cfg)
    probe = str(tmp / "probe")
    write_fake_processed_dataset(probe, n_scenes=3, splits=("test",),
                                 n_objects=200, n_points_per_obj=1,
                                 feat_dim=16, fmt="npz")
    assert write_student_targets(probe, "test", cfg, net,
                                 device="cpu") == 3
    out = {}
    for order, mode in (("x_fastest", "auto"), ("z_fastest", "auto"),
                        ("x_fastest", "z_fastest")):
        pth = str(tmp / f"{order}.pth")
        sd = to_minkowski_state_dict(*student_trees(net.state_dict()),
                                     arch="tiny", offset_order=order)
        torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, pth)
        dst = str(tmp / f"{order}_{mode}")
        args = ["--torch-ckpt", pth, "--out", dst, "--config", YAML,
                "--offset-order", mode, "--device", "cpu"]
        if mode == "auto":
            args += ["--probe-data", probe, "--probe-scenes", "3"]
        convert_checkpoint.main(args + ["--opts", *OPTS])
        with open(os.path.join(dst, "convert_meta.json")) as f:
            out[(order, mode)] = (dst, json.load(f))
    return cfg, net, out


@pytest.mark.parametrize("order", ["x_fastest", "z_fastest"])
def test_auto_picks_the_right_order(converted, order):
    """``--offset-order auto`` keeps the order the checkpoint was written
    in, its probe loss well below the other's (the probe's targets are
    the student's own outputs), and records both scores."""
    _, _, out = converted
    _, meta = out[(order, "auto")]
    assert meta["offset_order"] == order and meta["arch"] == "tiny"
    scores = meta["auto_scores"]
    other = next(o for o in scores if o != order)
    assert scores[order] < 0.5 * scores[other]


def test_converted_checkpoint_serves_the_student(converted):
    """The auto-converted checkpoint read by
    ``GroundingPipeline.from_checkpoint`` (the tiny-test text tower with
    random weights) holds the trained student's weights exactly, as does
    the ``last_model`` that a resume reads; the wrong order forced gives
    other k3 kernels."""
    cfg, net, out = converted
    want = net.state_dict()
    for key in (("x_fastest", "auto"), ("x_fastest", "z_fastest")):
        pipe = GroundingPipeline.from_checkpoint(
            YAML, out[key][0], clip_checkpoint="random",
            overrides=OPTS + ["clip_model", "tiny-test"], device="cpu")
        got = pipe.model.state_dict()
        same = all(torch.equal(got[k], want[k]) for k in want)
        assert same == (key[1] == "auto")
        # the file train_distil's resume reads holds the same weights
        last = restore_checkpoint(out[key][0])["model"]
        assert all(torch.equal(last[k], got[k]) for k in got)
    assert out[("x_fastest", "z_fastest")][1]["offset_order"] == "z_fastest"


def test_pick_order_refuses_a_nonfinite_score():
    """A NaN probe loss stops the conversion instead of picking blindly."""
    with pytest.raises(SystemExit, match="non-finite"):
        convert_checkpoint.pick_order({"x_fastest": float("nan"),
                                       "z_fastest": 0.5})
    assert convert_checkpoint.pick_order(
        {"x_fastest": 0.2, "z_fastest": 0.5}) == "x_fastest"
