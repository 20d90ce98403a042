"""The REGRAD slice of the port on the CPU against the JAX package: the
raw reader (every view, the aggregate, grasps and poses equal, world and
camera frames), ``process_regrad_scene`` (the same processed arrays:
xyz, rgb and labels equal, patch and per-object rows within 1e-5, float32
tiny-test teachers read from one synthesised CLIP file; h5 and ``.npz``
forms equal), ``preprocess_data -ds REGRAD``, ``RegradDistilDataset``
samples (equal), the ``export_scene`` / ``export_grasps`` files
(byte-equal), and the trainer CLI under ``configs/DistilREGRAD.yaml``
with the tiny student and REGRAD grounding queries, then
``make_visualizations`` with ``viz_query`` on its checkpoint."""

import os

import numpy as np
import pytest
import torch

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.data import regrad as jregrad
from dropclip_tpu.data.dataset_regrad import RegradDistilDataset as JDist
from dropclip_tpu.teachers import convert as jconvert
from dropclip_tpu.teachers.clip import build_clip as jbuild
from dropclip_tpu.teachers.extractor import ClipExtractor as JEx
from dropclip_tpu.tools import preprocess_data as jpre
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.data import regrad, scene_io
from dropclip_tpu_torch.data.dataset_regrad import (MAX_POINTS,
                                                    RegradDistilDataset)
from dropclip_tpu_torch.data.synthetic import write_fake_raw_regrad
from dropclip_tpu_torch.teachers import convert
from dropclip_tpu_torch.teachers.extractor import ClipExtractor
from dropclip_tpu_torch.tools import (make_visualizations, train_distil)
from dropclip_tpu_torch.tools import preprocess_data as tpre
from dropclip_tpu_torch.viz import load_pcd
from torch_cv2_stub import use_cv2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KMAT = np.array([[50.0, 0, 32.0], [0, 50.0, 24.0], [0, 0, 1]], np.float32)
RESIZE = (64, 96)


@pytest.fixture(scope="module", autouse=True)
def cv2_or_stand_in():
    """cv2 for the image files, or the stand-in where it is absent."""
    with pytest.MonkeyPatch.context() as mp:
        use_cv2(mp)
        yield


@pytest.fixture(scope="module")
def work(tmp_path_factory, cv2_or_stand_in):
    """A raw tree (train: 3 scenes, seen_val: 2) at 48x64, a synthesised
    tiny-test CLIP file, float32 extractors of both packages on it."""
    tmp = tmp_path_factory.mktemp("regrad")
    raw = str(tmp / "raw")
    sids = write_fake_raw_regrad(raw, n_scenes=3, n_objects=3, n_views=3,
                                 points_per_obj=120, K=KMAT, seed=0)
    vsids = write_fake_raw_regrad(raw, n_scenes=2, n_objects=2, n_views=2,
                                  points_per_obj=120, K=KMAT,
                                  split="seen_val", seed=1)
    clip = str(tmp / "clip.pt")
    torch.save(convert.synthetic_openai_state_dict("tiny-test", seed=4), clip)
    jex = JEx(jbuild("tiny-test", use_flash=False),
              {"params": jconvert.load_params(clip)}, img_resize=RESIZE)
    tex = ClipExtractor(convert.build_clip_from(
        "tiny-test", clip, dtype=torch.float32, device="cpu"),
        img_resize=RESIZE)
    return dict(tmp=tmp, raw=raw, sids=sids, vsids=vsids, clip=clip,
                jex=jex, tex=tex)


def _reader(raw, frame="world", **kw):
    return dict(root_dir=raw, num_views=9, camera_file="camera_info.npy",
                grasp_dir="Points", RGB_dir="RGBImages",
                Depth_dir="DepthImages", Seg_dir="SegmentationImages",
                reference_frame=frame, with_depth=True, with_seg=True,
                with_grasp=True, include_pc_filtered=True,
                gripper_type="marker", **kw)


def _same(a, b, path="scene"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert a.dtype == np.asarray(b).dtype, path
    else:
        assert a == b, path


@pytest.mark.parametrize("frame", ["world", "camera"])
def test_raw_reader_matches_jax(work, frame):
    """Both splits: every view (image, depth, segmentation, clouds, poses,
    boxes; views absent from the tree marked invalid), the aggregate with
    its filtered cloud, the grasps; gather_grasps for each view and all."""
    for split, sids in (("train", work["sids"]), ("seen_val", work["vsids"])):
        ds = regrad.RegradDataset(CfgNode(_reader(work["raw"], frame)), split)
        jds = jregrad.RegradDataset(JCfg(_reader(work["raw"], frame)), split)
        assert ds.scene_ids == jds.scene_ids == sids
        for i in range(len(ds)):
            got, ref = ds[i], jds[i]
            _same(got, ref)
            assert [v for v, e in got["views"].items() if e["valid"]] == \
                list(range(1, 4 if split == "train" else 3))
            for view in (0, 1, 2):
                g, j = ds.gather_grasps(got, view), jds.gather_grasps(ref,
                                                                       view)
                for k in ("indices", "poses", "scores", "labels"):
                    np.testing.assert_array_equal(getattr(g, k),
                                                  getattr(j, k))
    assert regrad.VIEWS_MAPPING == jregrad.VIEWS_MAPPING
    rng = np.random.default_rng(0)
    q = rng.standard_normal(4)
    np.testing.assert_array_equal(regrad._quat_to_matrix(q),
                                  jregrad._quat_to_matrix(q))
    m = regrad._quat_to_matrix(q)
    np.testing.assert_array_equal(regrad._matrix_to_quat(m),
                                  jregrad._matrix_to_quat(m))
    T, p = np.eye(4), rng.standard_normal((5, 3))
    T[:3, :3], T[:3, 3] = m, q[:3]
    np.testing.assert_array_equal(regrad._apply_se3(T, p),
                                  jregrad._apply_se3(T, p))


def test_exports_byte_equal(work, tmp_path):
    ds = regrad.RegradDataset(CfgNode(_reader(work["raw"])), "train")
    jds = jregrad.RegradDataset(JCfg(_reader(work["raw"])), "train")
    for tag, kw in (("agg", dict(view=0, seg=True, world_frame=True,
                                 camera_frames=True)),
                    ("v2", dict(view=2))):
        a = ds.export_scene(1, str(tmp_path / f"t_{tag}.pcd"), **kw)
        b = jds.export_scene(1, str(tmp_path / f"j_{tag}.pcd"), **kw)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), tag
    for tag, kw in (("top", dict(view=0, score_thresh=0.1, max_grasps=5,
                                 sort=True)),
                    ("obj", dict(view=1, score_thresh=0.0, object_only=1,
                                 sort=True, gripper_type="franka_panda")),
                    ("rand", dict(view=2, score_thresh=0.0, max_grasps=3))):
        got = ds.export_grasps(0, str(tmp_path / f"t_{tag}"),
                               rng=np.random.default_rng(1), **kw)
        ref = jds.export_grasps(0, str(tmp_path / f"j_{tag}"),
                                rng=np.random.default_rng(1), **kw)
        assert len(got) == len(ref) == 2
        for a, b in zip(got, ref):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), (tag, a)
    with pytest.raises(ValueError):
        ds.export_scene(0, str(tmp_path / "bad.pcd"), view=12)


@pytest.fixture(scope="module")
def processed(work):
    """Each train and seen_val scene through both packages'
    process_regrad_scene (h5), and the port's .npz form."""
    out = {k: str(work["tmp"] / k) for k in ("jax", "h5", "npz")}
    stats = {}
    for split in ("train", "seen_val"):
        ds = regrad.RegradDataset(CfgNode(_reader(work["raw"])), split)
        K = tpre.regrad_intrinsics(ds.camera_info)
        poses = {v: np.asarray(ds.camera_info["extrinsic"][v])
                 for v in range(1, 10)}
        for i, sid in enumerate(ds.scene_ids):
            scene = ds[i]
            for tag in out:
                ext = "npz" if tag == "npz" else "h5py"
                path = os.path.join(out[tag], split, f"{sid}.{ext}")
                if tag == "jax":
                    s = jpre.process_regrad_scene(scene, poses, K,
                                                  work["jex"], path, 0.005)
                else:
                    s = tpre.process_regrad_scene(scene, poses, K,
                                                  work["tex"], path, 0.005)
                stats[tag, sid] = s
    return dict(out=out, stats=stats)


def test_process_regrad_scene_matches_jax(work, processed):
    keys = ("xyz", "rgb", "label", "patch", "per_obj", "obj_ids")
    for split, sids in (("train", work["sids"]), ("seen_val", work["vsids"])):
        for sid in sids:
            path = lambda t, e="h5py": os.path.join(processed["out"][t],
                                                    split, f"{sid}.{e}")
            ref = scene_io.read_regrad_scene(path("jax"), keys)
            got = scene_io.read_regrad_scene(path("h5"), keys)
            npz = scene_io.read_regrad_scene(path("npz", "npz"), keys)
            js, ts = (processed["stats"][t, sid] for t in ("jax", "h5"))
            assert ts["points"] == js["points"] > 100
            assert ts["objects"] == js["objects"] and \
                ts["views"] == js["views"]
            for k in ("xyz", "rgb", "label", "obj_ids"):
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
                assert got[k].dtype == ref[k].dtype
            for k in ("patch", "per_obj"):
                np.testing.assert_allclose(got[k], ref[k], atol=1e-5,
                                           err_msg=k)
            for k in keys:
                np.testing.assert_array_equal(npz[k], got[k])


def test_regrad_label_ids_must_fit_uint8(tmp_path):
    z = np.zeros((2, 3), np.float32)
    for label, ids in ((np.array([3, 256]), np.array([3])),
                       (np.array([3, 3]), np.array([300]))):
        with pytest.raises(ValueError, match="uint8"):
            scene_io.write_regrad_scene(str(tmp_path / "s.npz"), z, z, label,
                                        z, z[:1], ids)


def test_preprocess_cli_regrad(work, tmp_path, capsys, monkeypatch):
    """``-ds REGRAD`` with the reader config and ``--start/--end``
    (exclusive): the CLI's files equal process_regrad_scene's; a rerun
    skips; an unreadable scene is skipped with its error."""
    monkeypatch.setattr(tpre, "build_extractor",
                        lambda args, device=None: work["tex"])
    out = str(tmp_path / "cli")
    argv = ["-ds", "REGRAD", "-r", work["raw"], "-c", out,
            "--reader-config", os.path.join(ROOT, "configs", "REGRAD.yaml"),
            "--voxel-size", "0.005", "--device", "cpu", "--format", "npz",
            "--start", "1", "--end", "3"]
    tpre.main(argv)
    assert sorted(os.listdir(os.path.join(out, "train"))) == \
        [f"{s}.npz" for s in work["sids"][1:]]
    keys = ("xyz", "label", "per_obj")
    for sid in work["sids"][1:]:
        a = scene_io.read_regrad_scene(os.path.join(out, "train",
                                                    f"{sid}.npz"), keys)
        b = scene_io.read_regrad_scene(os.path.join(
            str(work["tmp"] / "npz"), "train", f"{sid}.npz"), keys)
        for k in keys:
            np.testing.assert_array_equal(a[k], b[k])
    capsys.readouterr()
    os.remove(os.path.join(work["raw"], "train", "RGBImages",
                           f"{work['sids'][0]}_9.jpg"))
    try:
        tpre.main(argv[:-4] + ["--end", "-1"])
    finally:
        write_fake_raw_regrad(work["raw"], n_scenes=3, n_objects=3,
                              n_views=3, points_per_obj=120, K=KMAT, seed=0)
    printed = capsys.readouterr().out
    assert printed.count("exists, skipping") == 2
    assert f"{work['sids'][0]}: " in printed


def _dist_cfg(root, split_dir, feat_key="per_obj", **kw):
    return dict(processed_dir=split_dir,
                objects_train_path=os.path.join(root, "objects_single.json"),
                objects_val_path=os.path.join(root,
                                              "objects_refer_test.json"),
                cls_map_path=os.path.join(root, "cls_map.json"),
                voxel_size=0.005, voxel_capacity=1024, use_color=True,
                use_augmentation=True, aug_random_shift=True,
                use_color_augmentation=True,
                aug_elastic_distortion_granularity_min=0.1,
                aug_elastic_distortion_granularity_max=0.3,
                aug_elastic_distortion_magnitude_min=0.4,
                aug_elastic_distortion_magnitude_max=0.8,
                manual_seed=42, feat_key=feat_key, evaluate=True,
                val_split="seen_val", **kw)


@pytest.mark.parametrize("feat_key", ["per_obj", "patch"])
def test_distil_dataset_matches_jax(work, processed, feat_key):
    """Samples of the train (augmented) and seen_val splits equal the JAX
    dataset's on the same h5 scenes; the .npz scenes give the same
    samples."""
    for split in ("train", "seen_val"):
        over = _dist_cfg(work["raw"], processed["out"]["h5"], feat_key)
        ds, jds = RegradDistilDataset(CfgNode(over), split), JDist(
            JCfg(over), split)
        nds = RegradDistilDataset(CfgNode(dict(
            over, processed_dir=processed["out"]["npz"])), split)
        assert len(ds) == len(jds) == len(nds) > 0
        for i in range(len(ds)):
            got, ref, npz = ds[i], jds[i], nds[i]
            assert set(got) == set(ref)
            for k in got:
                _same(got[k], ref[k], k)
                _same(npz[k], got[k], k)
            assert got["mask"].sum() > 50 and got["queries"]
            assert (got["labels_cls"][got["mask"]] != 255).any()
        _same(RegradDistilDataset.collate([ds[0], ds[1]]),
              JDist.collate([jds[0], jds[1]]))
    assert MAX_POINTS == 10000
    with pytest.raises(ValueError, match="feat_key"):
        RegradDistilDataset(CfgNode(dict(over, feat_key="nope")), "train")[0]


def test_recipe_batch_keeps_every_voxel_on_the_brick_grid(work, processed):
    """At the recipe's 1 mm voxels (configs/DistilREGRAD.yaml: bricks of
    (4, 4, 2), the elastic distortion and shift), an augmented train batch
    reaches past the JAX package's fixed grid (grid_bits 5, +-64 voxels),
    which drops voxels; the port's grid (``grid_bits_for``) holds them
    all, at capacities autotuned as the trainer does."""
    from dropclip_tpu_torch.distill.engine import build_topology
    from dropclip_tpu_torch.sparse.bricks import (autotune_brick_capacities,
                                                  build_brick_topology)

    cfg = CfgNode(dict(_dist_cfg(work["raw"], processed["out"]["npz"]),
                       voxel_size=0.001, voxel_capacity=8192,
                       brick_shape=[4, 4, 2]))
    ds = RegradDistilDataset(cfg, "train")
    b = RegradDistilDataset.collate([ds[i] for i in range(len(ds))])
    coords, mask = torch.as_tensor(b["coords"]), torch.as_tensor(b["mask"])
    cfg.brick_capacities = list(autotune_brick_capacities(
        b["coords"], b["mask"], slack=1.5, brick_shape=(4, 4, 2)))
    topo = build_topology(cfg, coords, mask)
    assert int(topo.dropped.sum()) == 0 and int(mask.sum()) > 300
    fixed = build_brick_topology(coords, mask, grid_bits=5,
                                 brick_capacities=cfg.brick_capacities,
                                 brick_shape=(4, 4, 2))
    assert int(fixed.dropped[:, 0].sum()) > 0


def test_train_cli_regrad_and_viz_query(work, processed, tmp_path):
    """``train_distil`` under configs/DistilREGRAD.yaml (the tiny student,
    16-d targets, batch 2) on the port's .npz scenes: one epoch (one
    step of the three train scenes), grounding eval on the seen_val
    REGRAD queries with the synthesised CLIP file, a checkpoint; then
    ``make_visualizations`` with ``viz_query`` on that checkpoint writes
    every dump, the grasp scene with 10 ranked grippers."""
    import shutil

    data = str(tmp_path / "proc")
    for split in ("train", "seen_val"):
        os.makedirs(os.path.join(data, split))
        src = os.path.join(processed["out"]["npz"], split)
        for f in os.listdir(src):
            shutil.copy(os.path.join(src, f), os.path.join(data, split, f))
    objs = os.path.join(work["raw"], "objects_single.json")
    yaml = os.path.join(ROOT, "configs", "DistilREGRAD.yaml")
    opts = ["processed_dir", data, "objects_train_path", objs,
            "objects_val_path",
            os.path.join(work["raw"], "objects_refer_test.json"),
            "cls_map_path", os.path.join(work["raw"], "cls_map.json"),
            "arch_3d", "tiny", "feat_dim", "16", "voxel_size", "0.005",
            "voxel_capacity", "512", "batch_size_val", "2", "workers_val",
            "1", "clip_model", "tiny-test", "clip_checkpoint", work["clip"]]
    ckpt = train_distil.main(
        ["--config", yaml, "--device", "cpu", "--opts", *opts,
         "batch_size", "2", "workers", "2", "epochs", "1",
         "save_path", str(tmp_path / "exp"), "print_freq", "1"])
    with open(os.path.join(ckpt, "train.log")) as f:
        log = f.read()
    assert "Eval Grounding: Epoch=[0/1]" in log and "mIoU" in log
    assert "Distill-DistilREGRAD" in ckpt

    vdir = str(tmp_path / "viz")
    make_visualizations.main(
        ["--config", yaml, "--device", "cpu", "--opts", *opts, "resume",
         ckpt, "viz_dir", vdir, "max_scenes", "1", "viz_query", "the mug"])
    sid = work["vsids"][0]
    for suffix in ("rgb", "label", "target_pca", "student_pca", "panels",
                   "query_heatmap", "query_pred", "query_cloud"):
        xyz, col = load_pcd(os.path.join(vdir, f"{sid}_{suffix}.pcd"))
        assert len(xyz) and np.isfinite(xyz).all() and col is not None
    with open(os.path.join(vdir, f"{sid}_query_grasps.obj")) as f:
        assert f.read().count("o grasp_") == 10
