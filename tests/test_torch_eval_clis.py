"""The port's eval CLIs on the CPU (``--device cpu``) against the JAX
package's: ``run_eval``'s per-scene metrics in both fusion modes (float32
teachers read from one synthesised CLIP checkpoint file), the
fusion upper bound of ``validate_upper_bound`` on one fake dataset,
``make_visualizations``' dataset dumps byte for byte; and the port's own
runs on a checkpoint of its trainer (``validate_blender``, the teacher
cache, the viz dumps, the refusals), the gather engine's among them."""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import torch

from dropclip_tpu.data.synthetic import make_raw_scene
from dropclip_tpu_torch.core.checkpoint import BEST_NAME
from dropclip_tpu_torch.data.synthetic import write_fake_processed_dataset
from dropclip_tpu_torch.fusion.core import FusionConfig, borderline_points
from dropclip_tpu_torch.teachers import convert
from dropclip_tpu_torch.teachers.extractor import ClipExtractor
from dropclip_tpu_torch.tools import (make_visualizations, run_eval,
                                      train_distil, validate_blender,
                                      validate_upper_bound)
from dropclip_tpu_torch.viz import load_pcd

from torch_ddp_worker import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "DistilBlender.yaml")
RESIZE = (64, 96)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A fake dataset (h5, train and test splits, a cls_list.json), a
    synthesised tiny-test CLIP checkpoint file and a checkpoint of the
    port's trainer (one epoch of the tiny student)."""
    tmp = tmp_path_factory.mktemp("clis")
    data = str(tmp / "data")
    write_fake_processed_dataset(data, n_scenes=4, n_objects=2, feat_dim=16)
    with open(os.path.join(data, "cls_list.json"), "w") as f:
        json.dump({"1": "can", "2": "spoon", "3": "fork", "4": "mug"}, f)
    clip = str(tmp / "clip.pt")
    torch.save(convert.synthetic_openai_state_dict("tiny-test", seed=2), clip)
    opts = ["root_dir", data, "arch_3d", "tiny", "feat_dim", "16",
            "voxel_capacity", "256", "voxel_size", "0.02", "batch_size_val",
            "2", "workers_val", "1", "clip_model", "tiny-test",
            "clip_checkpoint", clip, "eval_scenario", "cls"]
    ckpt = train_distil.main(
        ["--config", YAML, "--device", "cpu", "--opts", *opts,
         "batch_size", "2", "workers", "2", "epochs", "1",
         "save_path", str(tmp / "exp"), "print_freq", "1"])
    return SimpleNamespace(tmp=tmp, data=data, clip=clip, opts=opts,
                           ckpt=ckpt)


def _jax_main(module, argv, monkeypatch, capsys):
    """A JAX CLI's main under ``argv``; its last JSON line."""
    monkeypatch.setattr(sys, "argv", argv)
    module.main()
    return json.loads([l for l in capsys.readouterr().out.splitlines()
                       if l.startswith("{")][-1])


def test_validate_blender_val_batch_divides_over_ranks(work, monkeypatch):
    """validate_blender refuses a val batch that does not divide over the
    ranks, as the trainer does: batch_size_val 1 at world size 2 would
    otherwise score a global batch of 2."""
    monkeypatch.setattr(validate_blender, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="must divide over 2 processes"):
        validate_blender.main(["--config", YAML, "--device", "cpu", "--opts",
                               *work.opts, "batch_size_val", "1", "resume",
                               work.ckpt])


def test_upper_bound_matches_jax_cli(work, monkeypatch, capsys):
    """The fused targets scored as the student's output: both packages'
    CLIs on one dataset and CLIP file print the same line (metrics within
    1e-6)."""
    from dropclip_tpu.tools import validate_upper_bound as jub

    argv = ["--config", YAML, "--opts", *work.opts, "use_full_pc", "True"]
    ref = _jax_main(jub, ["validate_upper_bound", *argv], monkeypatch,
                    capsys)
    got = validate_upper_bound.main(argv[:2] + ["--device", "cpu"]
                                    + argv[2:])
    assert got["eval_cfg"] == ref["eval_cfg"] and "UPPERBOUND" in \
        got["eval_cfg"]
    for k in ("mIoU", "Pr@25", "Pr@50", "Pr@75", "DistilLoss"):
        assert got[k] == pytest.approx(ref[k], abs=1e-6), k


def test_validate_blender_on_the_trainers_checkpoint(work, capsys):
    """The last and the best checkpoint, negatives from cls_list.json, the
    results file and the printed JSON line; the grounding metrics equal
    the trainer's own eval of the same weights; dropped voxels fail
    unless allowed."""
    base = ["--config", YAML, "--device", "cpu", "--opts", *work.opts,
            "resume", work.ckpt]
    out = str(work.tmp / "res" / "val.json")
    res = validate_blender.main(base + ["save_results_path", out])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out) as f:
        assert json.load(f) == line == res
    with open(os.path.join(work.ckpt, "train.log")) as f:
        log = f.read()
    assert f"Eval Grounding: Epoch=[0/1] {dict(list(res.items())[1:])}" \
        in log
    best = validate_blender.main(base + ["ckpt_name", BEST_NAME,
                                         "sim_negatives", "all"])
    assert "negatives[all]" in best["eval_cfg"]
    assert all(np.isfinite(v) for k, v in best.items() if k != "eval_cfg")
    small = ["brick_capacities", "[8, 8, 8, 8, 8]"]
    with pytest.raises(RuntimeError, match="allow_capacity_overflow"):
        validate_blender.main(base + small)
    assert np.isfinite(validate_blender.main(
        base + small + ["allow_capacity_overflow", "True"])["mIoU"])


def _extractors(ckpt):
    from dropclip_tpu.teachers import convert as jconvert
    from dropclip_tpu.teachers.clip import build_clip as jbuild
    from dropclip_tpu.teachers.extractor import ClipExtractor as JEx

    jex = JEx(jbuild("tiny-test", use_flash=False),
              {"params": jconvert.load_params(ckpt)}, img_resize=RESIZE)
    tex = ClipExtractor(convert.build_clip_from(
        "tiny-test", ckpt, dtype=torch.float32, device="cpu"),
        img_resize=RESIZE)
    return jex, tex


@pytest.mark.parametrize("use_obj_prior", [1, 0])
def test_run_eval_scene_matches_jax(work, use_obj_prior, monkeypatch):
    """eval_scene on two synthetic scenes, object-prior and dense patch
    fusion: per-view visibility equal except at borderline points
    (``fusion.core.borderline_points``), fused point features within 1e-5 at the points
    that are borderline in no view, the same query count, and the
    per-scene metrics within 1e-6 where visibility agrees everywhere.

    Points aggregated from a view project back onto exact integer pixels
    of it, where the integer-truncating projection flips with the last bit
    of the product; XLA's compiled code (jit, and the ``lax.scan`` of its
    point fusion) rounds those products otherwise than eager ops, so the
    JAX package's jitted and eager visibility already differ there (16 of
    4096 points of scene 0 in object-prior mode). Such scenes are reported
    rather than held; the JAX object-prior side runs eagerly, as the port
    does."""
    from dropclip_tpu.fusion import core as jfusion
    from dropclip_tpu.geom.aggregate import aggregate_views
    from dropclip_tpu.tools import run_eval as jrun

    fused = {}

    def keep(tag, fn):
        def run(*a, **k):
            fused[tag] = (a[0], fn(*a, **k))
            return fused[tag][1]
        return run

    monkeypatch.setattr(jrun, "_agg_jit", aggregate_views)
    monkeypatch.setattr(jrun, "_fuse_obj_jit",
                        keep("jax", jfusion.fuse_obj_prior))
    monkeypatch.setattr(jrun, "_fuse_pts_jit",
                        keep("jax", jfusion.fuse_points))
    monkeypatch.setattr(run_eval, "fuse_obj_prior",
                        keep("torch", run_eval.fuse_obj_prior))
    monkeypatch.setattr(run_eval, "fuse_points",
                        keep("torch", run_eval.fuse_points))
    jex, tex = _extractors(work.clip)
    args = SimpleNamespace(
        n_views=-1, max_objects=8, voxel_size=0.02, cloud_capacity=4096,
        kernel_queries="cls", use_visibility=0, use_similarity=1,
        use_sim_kernel="max", use_obj_prior=use_obj_prior,
        eval_scenario="cls", sim_negatives="scene", sim_method="paired",
        sim_thr=0.75, cache_dir=None, viz_dir=None, _cls_list=[])
    rng = np.random.default_rng(0)
    for i in range(2):
        raw = make_raw_scene(rng, n_objects=3, n_views=4)
        raw["scene_id"] = f"{i:04d}"
        ref = jrun.eval_scene(raw, jex, args)
        got = run_eval.eval_scene(raw, tex, args)
        assert set(got) == set(ref) and got["n_queries"] == ref["n_queries"]
        points = np.asarray(fused["jax"][0])
        np.testing.assert_array_equal(fused["torch"][0].numpy(), points)
        jvis = np.asarray(fused["jax"][1].visibility)
        tvis = fused["torch"][1].visibility.numpy()
        flips = jvis != tvis
        border = borderline_points(
            *map(torch.as_tensor, (points, raw["depths"], raw["poses"],
                                   raw["K"])),
            FusionConfig(image_hw=raw["depths"].shape[1:])).numpy()
        assert not (flips & ~border).any(), np.argwhere(flips & ~border)
        if not use_obj_prior:
            clear = ~border.any(0)
            assert clear.mean() > 0.5
            jf = np.asarray(fused["jax"][1].features)[clear]
            tf = fused["torch"][1].features.numpy()[clear]
            np.testing.assert_array_equal(np.isnan(tf), np.isnan(jf))
            np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-5)
        if flips.any():
            print(f"scene {i}: {int(flips.sum())} (view, point) visibility "
                  f"flips, all at borderline projections; metrics {got} vs "
                  f"{ref}")
            continue
        for k in ("mIoU", "Pr@25", "Pr@50", "Pr@75"):
            assert got[k] == pytest.approx(ref[k], abs=1e-6), (i, k)


def test_run_eval_cli(work, monkeypatch, capsys):
    """Both fusion modes through main on a checkpoint file; the teacher
    cache serves a second run without extraction; viz dumps and the
    results file; -ds Blender without -r refuses (tests/test_torch_blender.py
    runs it)."""
    base = ["-ds", "Synthetic", "--n-scenes", "1", "--clip-model",
            "tiny-test", "--clip-checkpoint", work.clip, "--max_objects",
            "8", "--voxel_size", "0.02", "--device", "cpu"]
    cache, vdir = str(work.tmp / "cache"), str(work.tmp / "rviz")
    res_path = str(work.tmp / "run_eval.json")
    for mode in ("1", "0"):
        argv = base + ["--use_obj_prior", mode, "--cache-dir", cache]
        first = run_eval.main(argv + ["--viz-dir", vdir,
                                      "--save-results", res_path])
        assert first["n_scenes"] == 1
        assert np.isfinite(first["mean"]["mIoU"])
        with open(res_path) as f:
            assert json.load(f)["mean"] == first["mean"]

        def boom(*a, **k):
            raise AssertionError("extraction ran despite a warm cache")

        monkeypatch.setattr(ClipExtractor, "extract_obj_prior", boom)
        monkeypatch.setattr(ClipExtractor, "extract", boom)
        assert run_eval.main(argv)["mean"] == first["mean"]
        monkeypatch.undo()
    assert sorted(f.split("_")[1] for f in os.listdir(cache)) == \
        ["objprior", "patch"]
    pcds = [f for f in os.listdir(vdir) if f.endswith(".pcd")]
    assert pcds and load_pcd(os.path.join(vdir, pcds[0]))[0].shape[1] == 3
    capsys.readouterr()
    with pytest.raises(SystemExit):  # -ds Blender needs its raw root
        run_eval.main(["-ds", "Blender", "--device", "cpu"])


def test_make_visualizations(work, monkeypatch, capsys):
    """Without a checkpoint the dataset dumps (rgb, labels, PCA of the
    targets) are byte-equal to the JAX tool's; with the trainer's
    checkpoint the student's PCA and the panels follow and read back, and
    with viz_query the query heatmap, panels and ranked grasp scene
    (tests/test_torch_grasp.py holds them against the JAX tool's steps)."""
    from dropclip_tpu.tools import make_visualizations as jviz

    jdir, tdir = str(work.tmp / "jviz"), str(work.tmp / "tviz")
    common = [*work.opts, "use_full_pc", "True", "max_scenes", "2"]
    monkeypatch.setattr(sys, "argv", ["make_visualizations", "--config",
                                      YAML, "--opts", *common, "viz_dir",
                                      jdir])
    jviz.main()
    make_visualizations.main(["--config", YAML, "--device", "cpu", "--opts",
                              *common, "viz_dir", tdir])
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 6
    for n in names:
        with open(os.path.join(jdir, n), "rb") as a, \
                open(os.path.join(tdir, n), "rb") as b:
            assert a.read() == b.read(), n
    make_visualizations.main(["--config", YAML, "--device", "cpu", "--opts",
                              *common, "viz_dir", tdir, "resume",
                              work.ckpt])
    for n in ("test_0000_student_pca.pcd", "test_0000_panels.pcd"):
        xyz, col = load_pcd(os.path.join(tdir, n))
        assert len(xyz) and np.isfinite(xyz).all() and col is not None
    make_visualizations.main(["--config", YAML, "--device", "cpu",
                              "--opts", *common, "viz_dir", tdir, "resume",
                              work.ckpt, "viz_query", "a mug"])
    for n in ("test_0000_query_heatmap.pcd", "test_0001_query_pred.pcd",
              "test_0000_query_cloud.pcd"):
        xyz, col = load_pcd(os.path.join(tdir, n))
        assert len(xyz) and col is not None
    with open(os.path.join(tdir, "test_0001_query_grasps.obj")) as f:
        assert f.read().count("o grasp_") == 10


def test_gather_engine_trains_and_validates(work, capsys):
    """``sparse_backend gather`` through the trainer (one epoch of the
    tiny gather student) and ``validate_blender`` on its checkpoint. The
    fake scenes are random clouds, denser than surfaces, so the default
    level capacities (halving per level) overflow: the trainer warns with
    the count, and validation refuses to score truncated scenes unless
    allowed (the JAX package drops the same voxels and reports 0). Allowed,
    the grounding metrics equal the trainer's own eval of the same
    weights; at world size 2 (two gloo processes) each rank scores its
    half of the val split and rank 0 prints the ranks' mean, finite and
    with the same keys."""
    opts = [*work.opts, "sparse_backend", "gather"]
    ckpt = train_distil.main(
        ["--config", YAML, "--device", "cpu", "--opts", *opts,
         "batch_size", "2", "workers", "2", "epochs", "1",
         "save_path", str(work.tmp / "gather"), "print_freq", "1"])
    with open(os.path.join(ckpt, "train.log")) as f:
        log = f.read()
    assert "voxels/bricks dropped by capacity overflow" in log
    base = ["--config", YAML, "--device", "cpu", "--opts", *opts, "resume",
            ckpt]
    with pytest.raises(RuntimeError, match="allow_capacity_overflow"):
        validate_blender.main(base)
    base += ["allow_capacity_overflow", "True"]
    res = validate_blender.main(base)
    capsys.readouterr()
    assert f"Eval Grounding: Epoch=[0/1] {dict(list(res.items())[1:])}" \
        in log
    cmd = [sys.executable, "-m", "dropclip_tpu_torch.tools.validate_blender",
           *base]
    out = launch([cmd, cmd], 2)
    for rc, _, err in out:
        assert rc == 0, err[-3000:]
    assert not out[1][1].strip()
    two = json.loads(out[0][1].strip().splitlines()[-1])
    assert set(two) == set(res)
    assert all(np.isfinite(v) for k, v in two.items() if k != "eval_cfg")
