"""The raw MV-TOD slice of the port on the CPU against the JAX package:
the raw tree writer (files byte-equal), the reader's tables and arrays
(equal), ``preprocess_data -ds Blender`` (the same h5 scenes: xyz and rgb
within 1e-6, labels and visibility equal, fused rows within 1e-4, as the
ingest test holds ``process_scene``; the ``.npz`` form equal to the h5),
the dataset's ``use_view_clip`` features (within 1e-5) and
``run_eval -ds Blender`` (the same scenes by real id; object-prior
metrics within 1e-6 where visibility agrees). Teachers are the float32
tiny-test CLIP read from one synthesised checkpoint file on both sides."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.data import blender as jblender
from dropclip_tpu.data import rle as jrle
from dropclip_tpu.data import scene_io as jio
from dropclip_tpu.data import synthetic as jsyn
from dropclip_tpu.data.dataset_blender import MVTODDataset as JDataset
from dropclip_tpu.teachers import convert as jconvert
from dropclip_tpu.teachers.clip import build_clip as jbuild
from dropclip_tpu.teachers.extractor import ClipExtractor as JEx
from dropclip_tpu.tools import preprocess_data as jpre
from dropclip_tpu.tools import run_eval as jrun
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.data import blender, scene_io, synthetic
from dropclip_tpu_torch.data.dataset_blender import MVTODDataset
from dropclip_tpu_torch.teachers import convert
from dropclip_tpu_torch.teachers.extractor import ClipExtractor
from dropclip_tpu_torch.tools import preprocess_data as tpre
from dropclip_tpu_torch.tools import run_eval
from torch_cv2_stub import use_cv2

RESIZE = (64, 96)
RAW = dict(n_scenes=2, n_objects=3, n_views=4, seed=0)


@pytest.fixture(scope="module", autouse=True)
def cv2_or_stand_in():
    """cv2 for the image files, or the stand-in where it is absent."""
    with pytest.MonkeyPatch.context() as mp:
        use_cv2(mp)
        yield


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_codec():
    """The JAX package's RLE codec on its numpy path: its C loader builds
    inside dropclip_tpu/native/, where these tests write nothing."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrle, "_native", lambda: None)
        yield


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def work(tmp_path_factory, cv2_or_stand_in):
    """Raw trees written by both packages, a synthesised tiny-test CLIP
    file and float32 extractors on it (JAX, port)."""
    tmp = tmp_path_factory.mktemp("blender")
    raw, jraw = str(tmp / "raw"), str(tmp / "jraw")
    synthetic.write_fake_raw_blender(raw, **RAW)
    jsyn.write_fake_raw_blender(jraw, **RAW)
    clip = str(tmp / "clip.pt")
    torch.save(convert.synthetic_openai_state_dict("tiny-test", seed=3), clip)
    return dict(tmp=tmp, raw=raw, jraw=jraw, clip=clip)


def _extractors(clip, mode="cls", resize=RESIZE):
    jex = JEx(jbuild("tiny-test", use_flash=False),
              {"params": jconvert.load_params(clip)}, mode=mode,
              img_resize=resize)
    tex = ClipExtractor(convert.build_clip_from(
        "tiny-test", clip, dtype=torch.float32, device="cpu"), mode=mode,
        img_resize=resize)
    return jex, tex


def test_raw_writer_matches_jax(work):
    names = _files(work["raw"])
    assert names == _files(work["jraw"]) and len(names) == 2 * (4 * 3 + 4) + 1
    for n in names:
        with open(os.path.join(work["raw"], n), "rb") as a, \
                open(os.path.join(work["jraw"], n), "rb") as b:
            assert a.read() == b.read(), n


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
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_reader_tables_and_arrays_equal(work, tmp_path):
    """Every table (objects_info, queries, col_to_ins, ins_to_cls), array
    (rgb, depth, decoded masks) and camera of both scenes, the seg maps,
    and the grasp loaders (json and h5, ``grasp_root``) equal."""
    h5py = pytest.importorskip("h5py")
    gdir = tmp_path / "grasps"
    gdir.mkdir()
    rng = np.random.default_rng(0)
    tf = np.tile(np.eye(4), (5, 1, 1)).astype(np.float32)
    tf[:, :3, 3] = rng.random((5, 3))
    with open(gdir / "Mug_bowl_0.02.json", "w") as f:
        json.dump({"transforms": tf.tolist(),
                   "quality_flex_object_in_gripper": [1, 0, 1, 1, 0],
                   "object_scale": 0.5}, f)
    with h5py.File(gdir / "Bowl_bottle_0.1.h5", "w") as f:
        f["grasps/transforms"] = tf
        f["grasps/qualities/flex/object_in_gripper"] = np.arange(5) % 2
        f["object/scale"] = 0.25
    for grasp_root in (None, str(gdir)):
        ds = blender.BlenderDataset(work["raw"], grasp_root=grasp_root)
        jds = jblender.BlenderDataset(work["raw"], grasp_root=grasp_root)
        assert ds.scene_ids == jds.scene_ids == ["000000", "000001"]
        _same(ds.id_to_name, jds.id_to_name)
        for i in range(len(ds)):
            got, ref = ds[i], jds[i]
            _same(got, ref)
            _same(blender.BlenderDataset.obtain_seg_info(got),
                  jblender.BlenderDataset.obtain_seg_info(ref))
    assert "grasps" in got["objects_info"][1] and \
        "grasps" in got["objects_info"][2]
    for name in ("Mug_bowl_0.02.json", "Bowl_bottle_0.1.h5"):
        _same(blender.BlenderDataset.load_grasps(str(gdir / name)),
              jblender.BlenderDataset.load_grasps(str(gdir / name)))
    with pytest.raises(RuntimeError, match="grasp file ending"):
        blender.BlenderDataset.load_grasps("x.txt")


def _ingest_argv(work, out, *extra):
    return ["-ds", "Blender", "-r", work["raw"], "-c", out, "--clip-model",
            "tiny-test", "--voxel-size", "0.001", *extra]


@pytest.fixture(scope="module")
def ingested(work, tmp_path_factory):
    """``preprocess_data -ds Blender`` of both packages (h5), and the
    port's ``--format npz`` run, with float32 extractors swapped in."""
    jex, tex = _extractors(work["clip"])
    out = {k: str(tmp_path_factory.mktemp(k)) for k in ("jax", "h5", "npz")}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jpre, "build_extractor", lambda args: jex)
        mp.setattr(tpre, "build_extractor", lambda args, device=None: tex)
        mp.setattr(sys, "argv", ["preprocess_data",
                                 *_ingest_argv(work, out["jax"])])
        jpre.main()
        tpre.main(_ingest_argv(work, out["h5"], "--device", "cpu"))
        tpre.main(_ingest_argv(work, out["npz"], "--device", "cpu",
                               "--format", "npz", "--end", "1"))
        tpre.main(_ingest_argv(work, out["npz"], "--device", "cpu",
                               "--format", "npz", "--start", "1"))
    finally:
        mp.undo()
    return out


def test_run_blender_matches_jax(work, ingested, capsys):
    """Both scenes: the h5 files of the two packages hold the same cloud
    and fused rows; the .npz run (in two --start/--end windows, --end
    exclusive) holds the port's h5 arrays exactly; a rerun skips both."""
    for sid in ("000000", "000001"):
        ref = jio.read_scene(os.path.join(ingested["jax"], "train", sid,
                                          f"{sid}.h5py"))
        got = scene_io.read_scene(os.path.join(ingested["h5"], "train", sid,
                                               f"{sid}.h5py"))
        npz = scene_io.read_scene(os.path.join(ingested["npz"], "train", sid,
                                               f"{sid}.npz"))
        assert len(got.xyz) > 50
        np.testing.assert_allclose(got.xyz, ref.xyz, atol=1e-6)
        np.testing.assert_allclose(got.rgb, ref.rgb, atol=1e-6)
        np.testing.assert_array_equal(got.label, ref.label)
        np.testing.assert_array_equal(got.vis_mask, ref.vis_mask)
        np.testing.assert_allclose(got.obj_feats, ref.obj_feats, atol=1e-4)
        assert got.objects_info == ref.objects_info
        for a, b in zip(npz, got):
            _same(a, b)
    capsys.readouterr()
    tex = _extractors(work["clip"])[1]
    argv = _ingest_argv(work, ingested["h5"], "--device", "cpu")
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(tpre, "build_extractor", lambda args, device=None: tex)
        tpre.main(argv)
    assert capsys.readouterr().out.count("exists") == 2
    with pytest.raises(NotImplementedError, match="ingest_scaling"):
        tpre.main(argv + ["--n-devices", "2"])
    with pytest.raises(SystemExit):
        tpre.main(["-ds", "Blender", "-c", ingested["h5"]])


def _vc_over(work, processed):
    return dict(root_dir=processed, raw_root=work["raw"], voxel_size=0.002,
                voxel_capacity=512, use_full_pc=False, use_k_views=0,
                use_view_ids="1,3", use_color=True, use_augmentation=True,
                aug_random_shift=True, aug_random_rotation=True,
                aug_elastic_distortion_granularity_min=0.1,
                aug_elastic_distortion_granularity_max=0.3,
                aug_elastic_distortion_magnitude_min=0.4,
                aug_elastic_distortion_magnitude_max=0.8,
                eval_scenario="cls", manual_seed=42, use_view_clip=True,
                view_clip_model="tiny-test", view_clip_resize=(32, 48),
                view_clip_hw=(48, 64),
                view_clip_intrinsics=(50.0, 50.0, 31.5, 23.5),
                clip_checkpoint=work["clip"])


def test_view_clip_features_match_jax(work, ingested):
    """use_view_clip samples: the per-point view features within 1e-5 of
    the JAX dataset's, whole samples (augmented; in_feats 3 + 3 + 16
    wide) within 1e-5, the patch maps cached per view; the stem of the
    student is built that wide."""
    from dropclip_tpu.ops.resize import bicubic_sample_at as jsample
    from dropclip_tpu_torch.distill.engine import (build_student_for,
                                                   student_in_channels)

    over = _vc_over(work, ingested["h5"])
    jex, tex = _extractors(work["clip"], "patch", (32, 48))
    jds, ds = JDataset(JCfg(over), "train"), MVTODDataset(
        CfgNode(over), "train", device="cpu")
    jds._vc_extractor = jex
    jds._vc_sample = jax.jit(lambda s, x, y: jsample(s, (48, 64), x, y))
    ds._vc_extractor = tex
    assert len(ds) == len(jds) == 4
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(300, 3)) * 0.3
    for sid in ("000000", "000001"):
        for v in (0, 3):
            np.testing.assert_allclose(
                ds._view_clip_features(xyz, sid, v),
                jds._view_clip_features(xyz, sid, v), rtol=1e-5, atol=1e-5)
    for i in range(len(ds)):
        got, ref = ds[i], jds[i]
        assert got["in_feats"].shape[-1] == 22
        for k in ("coords", "mask", "labels", "inverse_map"):
            np.testing.assert_array_equal(got[k], ref[k])
        for k in ("in_feats", "targets"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5)
    # views 0 and 3 above, 1 and 3 in the samples, of two scenes
    assert ds.vc_misses == 6 and len(ds._vc_cache) == 6
    ds[0]
    assert ds.vc_misses == 6
    cfg = CfgNode(over)
    assert student_in_channels(cfg) == 22
    cfg.arch_3d = "tiny"
    stem = [p for n, p in build_student_for(cfg).named_parameters()
            if p.dim() == 3][0]
    assert stem.shape[1] == 22
    with pytest.raises(ValueError, match="single views"):
        MVTODDataset(CfgNode(dict(over, use_k_views=2)), "train",
                     device="cpu")[0]


def test_run_eval_blender_matches_jax(work, monkeypatch, capsys):
    """``run_eval -ds Blender`` over the raw tree (``--end`` inclusive):
    the same scenes by their real ids, the same query counts; object-prior
    metrics within 1e-6 per scene where the fused visibility of the two
    packages agrees (borderline projections may flip: see
    test_torch_eval_clis); both fusion modes finite; the cache keyed by
    the real scene id."""
    from dropclip_tpu.fusion import core as jfusion
    from dropclip_tpu.geom.aggregate import aggregate_views

    jex, tex = _extractors(work["clip"])
    seen = {"jax": [], "torch": []}
    vis = {"jax": [], "torch": []}

    def keep(tag, fn, store):
        def run(*a, **k):
            out = fn(*a, **k)
            store[tag].append(out)
            return out
        return run

    monkeypatch.setattr(jrun, "build_extractor", lambda args: jex)
    monkeypatch.setattr(run_eval, "build_extractor",
                        lambda args, device=None: tex)
    monkeypatch.setattr(jrun, "_agg_jit", aggregate_views)
    monkeypatch.setattr(jrun, "_fuse_obj_jit",
                        keep("jax", jfusion.fuse_obj_prior, vis))
    monkeypatch.setattr(run_eval, "fuse_obj_prior",
                        keep("torch", run_eval.fuse_obj_prior, vis))
    monkeypatch.setattr(jrun, "eval_scene",
                        keep("jax", jrun.eval_scene, seen))
    monkeypatch.setattr(run_eval, "eval_scene",
                        keep("torch", run_eval.eval_scene, seen))
    cache = str(work["tmp"] / "cache")
    base = ["-ds", "Blender", "-r", work["raw"], "--clip-model", "tiny-test",
            "--max_objects", "8", "--voxel_size", "0.01",
            "--sim_negatives", "all", "--sim_thr", "0.5", "--start", "0",
            "--end", "1"]
    monkeypatch.setattr(sys, "argv", ["run_eval", *base])
    jrun.main()
    got = run_eval.main(base + ["--device", "cpu", "--cache-dir", cache])
    assert got["n_scenes"] == 2 and len(seen["torch"]) == 2
    held = []
    for i, (g, r) in enumerate(zip(seen["torch"], seen["jax"])):
        assert set(g) == set(r) and g["n_queries"] == r["n_queries"] > 0
        jv = np.asarray(vis["jax"][i].visibility)
        tv = vis["torch"][i].visibility.numpy()
        if (jv != tv).any():
            print(f"scene {i}: {int((jv != tv).sum())} visibility flips; "
                  f"metrics {g} vs {r}")
            continue
        for k in ("mIoU", "Pr@25", "Pr@50", "Pr@75"):
            assert g[k] == pytest.approx(r[k], abs=1e-6), (i, k)
        held.append(g["mIoU"])
    assert max(held) > 0, "no scene held, or every held mIoU 0"
    assert sorted(f.split("_")[0] for f in os.listdir(cache)) == \
        ["000000", "000001"]
    patch = run_eval.main(base + ["--device", "cpu", "--use_obj_prior", "0",
                                  "--end", "-1"])
    assert patch["n_scenes"] == 2 and np.isfinite(patch["mean"]["mIoU"])
    with pytest.raises(SystemExit):
        run_eval.main(["-ds", "Blender", "--device", "cpu"])


def test_view_clip_stem_carries_across_from_jax():
    """The 774-wide stem of use_view_clip with ViT-L/14@336px features (6
    + 768): the flax student initialised on a 774-wide input converts
    through ``convert.student_state_dict`` into the port's student, which
    ``build_student_for`` sizes from the config alone; outputs agree
    within 1e-4 (float32 both sides)."""
    import jax.numpy as jnp

    from dropclip_tpu.distill.engine import build_student_for as jstudent
    from dropclip_tpu.distill.engine import build_topology as jtopology
    from dropclip_tpu_torch.convert import student_state_dict
    from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
    from dropclip_tpu_torch.distill.engine import (build_student_for,
                                                   build_topology)
    from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities

    coords, mask = make_tabletop_coords(np.random.RandomState(0), 2, 256,
                                        n_occ=180, ext=10)
    caps = autotune_brick_capacities(coords, mask, brick_shape=(4, 4, 2))
    over = dict(arch_3d="tiny", feat_dim=16, use_color=True,
                use_view_clip=True, sparse_backend="bricks",
                brick_shape=[4, 4, 2], brick_capacities=list(caps),
                remat=False, fold_batch=True)
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 256, 774).astype(np.float32) * mask[..., None]
    jcfg = JCfg(dict(over))
    model = jstudent(jcfg)
    jtopo = jtopology(jcfg, jnp.asarray(coords), jnp.asarray(mask))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda t, f: model.init(jax.random.PRNGKey(0), t, f, train=False))(
            jtopo, jnp.asarray(feats)))
    ref = np.asarray(jax.jit(lambda v, t, f: model.apply(
        v, t, f, train=False))(variables, jtopo, jnp.asarray(feats)))
    cfg = CfgNode(dict(over))
    net = build_student_for(cfg)
    net.load_state_dict(student_state_dict(variables["params"],
                                           variables["batch_stats"]))
    stem = [p for p in net.parameters() if p.dim() == 3][0]
    assert stem.shape[1] == 774
    with torch.no_grad():
        got = net(build_topology(cfg, torch.as_tensor(coords),
                                 torch.as_tensor(mask)),
                  torch.as_tensor(feats)).numpy()
    assert np.abs(ref[mask]).max() > 1e-2
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
