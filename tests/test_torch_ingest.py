"""Offline ingest end to end: dropclip_tpu_torch.tools.preprocess_data
against dropclip_tpu.tools.preprocess_data on the same make_raw_scene with
the tiny-test CLIP (JAX init carried across), both writing h5 files that
are read back and compared; the extractor's per-view prompt path
(``DROPCLIP_PACKED_PROMPTS=0``) against the JAX package's."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.data import queries as jq
from dropclip_tpu.data import scene_io as jio
from dropclip_tpu.data import synthetic as jsyn
from dropclip_tpu.teachers.clip import build_clip as jbuild
from dropclip_tpu.teachers.extractor import ClipExtractor as JExtractor
from dropclip_tpu.tools import preprocess_data as jpre
from dropclip_tpu_torch.convert import clip_state_dict
from dropclip_tpu_torch.data import queries as tq
from dropclip_tpu_torch.data import scene_io as tio
from dropclip_tpu_torch.data import synthetic as tsyn
from dropclip_tpu_torch.teachers.clip import build_clip
from dropclip_tpu_torch.teachers.extractor import ClipExtractor
from dropclip_tpu_torch.tools import preprocess_data as tpre

RESIZE = (64, 96)


@pytest.fixture(scope="module")
def extractors():
    clip = jbuild("tiny-test", use_flash=False)
    r = clip.image_resolution
    cvars = jax.jit(lambda p, t: clip.init(jax.random.PRNGKey(5), p, t))(
        jnp.zeros((1, r, r, 3)), jnp.zeros((1, 77), jnp.int32))
    model = build_clip("tiny-test", device="cpu")
    model.load_state_dict(clip_state_dict(
        jax.tree_util.tree_map(np.asarray, cvars["params"])))
    return (JExtractor(clip, cvars, img_resize=RESIZE),
            ClipExtractor(model, img_resize=RESIZE))


def _scene(seed=0, n_objects=3):
    return jsyn.make_raw_scene(np.random.default_rng(seed),
                               n_objects=n_objects, n_views=4)


def _kw(raw, out_path):
    return dict(images=raw["images"], depths=raw["depths"], segs=raw["segs"],
                poses=raw["poses"], K=raw["K"], obj_info=raw["objects_info"],
                out_path=out_path, voxel_size=0.01, cloud_capacity=4096,
                max_objects=8)


@pytest.mark.parametrize("sim_kernel", ["max", "mean"])
def test_process_scene_matches_jax(tmp_path, extractors, sim_kernel):
    """The two h5 files: cloud (xyz, rgb within 1e-6; labels and
    visibility equal), fused object features within 1e-4 (float32 towers,
    NaN rows replaced by the same text embeddings), metadata equal; and
    the same stats."""
    jex, tex = extractors
    raw = _scene()
    jpath, tpath = str(tmp_path / "jax.h5py"), str(tmp_path / "torch.h5py")
    jstats = jpre.process_scene(extractor=jex, sim_kernel=sim_kernel,
                                **_kw(raw, jpath))
    tstats = tpre.process_scene(extractor=tex, sim_kernel=sim_kernel,
                                **_kw(raw, tpath))
    for key in ("points", "objects", "nan_objects"):
        assert tstats[key] == jstats[key]
    assert tstats["points"] > 0 and tstats["dropped"] == 0
    ref, got = jio.read_scene(jpath), tio.read_scene(tpath)
    np.testing.assert_allclose(got.xyz, ref.xyz, atol=1e-6)
    np.testing.assert_allclose(got.rgb, ref.rgb, atol=1e-6)
    np.testing.assert_array_equal(got.label, ref.label)
    np.testing.assert_array_equal(got.vis_mask, ref.vis_mask)
    np.testing.assert_array_equal(got.obj_ids, ref.obj_ids)
    assert np.isfinite(got.obj_feats).all()
    np.testing.assert_allclose(got.obj_feats, ref.obj_feats, rtol=1e-4,
                               atol=1e-4)
    assert got.objects_info == ref.objects_info == raw["objects_info"]


def test_writer_seam_and_async_path(tmp_path, extractors):
    """``write=`` receives write_scene's keyword arguments; the one-slot
    SceneWriter returns the stats through ``results``."""
    _, tex = extractors
    raw = _scene(1)
    seen = {}

    def capture(path, **scene):
        seen[path] = scene

    stats = tpre.process_scene(extractor=tex, write=capture,
                               **_kw(raw, "mem://a"))
    scene = seen["mem://a"]
    assert set(scene) == {"xyz", "rgb", "label", "vis_mask", "obj_feats",
                          "objects_info"}
    assert scene["xyz"].shape == (stats["points"], 3)
    assert scene["vis_mask"].shape == (4, stats["points"])
    path = str(tmp_path / "s" / "b.h5py")
    with tpre.SceneWriter() as writer:
        out = tpre.process_scene(extractor=tex, writer=writer,
                                 **_kw(raw, path))
        assert "points" not in out  # stats come from the writer thread
    (tag, async_stats), = writer.results
    assert tag == path and async_stats["points"] == stats["points"]
    np.testing.assert_allclose(tio.read_scene(path).xyz, scene["xyz"])


def test_stage_scene_wire_dtypes():
    raw = _scene(2)
    staged = tpre.stage_scene(raw["images"], raw["depths"], raw["segs"],
                              raw["poses"], raw["K"], device="cpu")
    assert staged["images"].dtype == torch.uint8
    assert staged["segs"].dtype == torch.uint8
    assert staged["depths"].dtype == torch.float16
    np.testing.assert_array_equal(
        staged["depths"].float().numpy(),
        raw["depths"].astype(np.float16).astype(np.float32))


def test_make_raw_scene_equal_between_packages():
    for seed, kw in ((0, {}), (3, dict(n_objects=10, n_points_per_obj=40,
                                      n_views=6, hw=(60, 80)))):
        a = jsyn.make_raw_scene(np.random.default_rng(seed), **kw)
        b = tsyn.make_raw_scene(np.random.default_rng(seed), **kw)
        assert set(a) == set(b)
        for key in a:
            if key == "objects_info":
                assert a[key] == b[key]
            else:
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("scenario", jq.SCENARIOS[:2] + jq.SCENARIOS[3:])
def test_fusion_queries_equal_between_packages(scenario):
    info = _scene(4, n_objects=5)["objects_info"]
    info[2]["concepts"]["Brand"] = "acme"
    assert tq.prepare_fusion_queries(info, scenario) == \
        jq.prepare_fusion_queries(info, scenario)
    with pytest.raises(ValueError):
        tq.prepare_fusion_queries(info, "nonsense")


def test_query_embeddings_match_jax(extractors):
    """embed_fusion_queries and encode_text: float32 within 1e-5."""
    jex, tex = extractors
    info = _scene(5)["objects_info"]
    np.testing.assert_allclose(
        tpre.embed_fusion_queries(tex, info).numpy(),
        np.asarray(jpre.embed_fusion_queries(jex, info)), rtol=1e-5,
        atol=1e-5)
    texts = ["a red mug", "table", "the bowl"]
    np.testing.assert_allclose(tex.encode_text(texts).numpy(),
                               np.asarray(jex.encode_text(texts)),
                               rtol=1e-5, atol=1e-5)


def test_cli_synthetic_on_cpu(tmp_path, capsys):
    """``-ds Synthetic --device cpu`` writes one readable scene; the
    unported readers are refused."""
    tpre.main(["-ds", "Synthetic", "-c", str(tmp_path), "--n-scenes", "1",
               "--clip-model", "tiny-test", "--voxel-size", "0.01",
               "--device", "cpu"])
    path = os.path.join(tmp_path, "train", "000000", "000000.h5py")
    scene = tio.read_scene(path)
    assert len(scene.xyz) > 0 and np.isfinite(scene.obj_feats).all()
    assert "000000: {'points'" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tpre.main(["-ds", "Blender", "-c", str(tmp_path)])


def _prompt_scene(rng, v=11, h=40, w=48, k=6):
    """Views with up to k-1 rectangular objects each (id 0 background);
    object k never appears."""
    imgs = (rng.rand(v, h, w, 3) * 255).astype(np.uint8)
    segs = np.zeros((v, h, w), np.int32)
    for i in range(v):
        for o in range(1, k):
            if rng.rand() < 0.6:
                y, x = rng.randint(0, h - 10), rng.randint(0, w - 10)
                segs[i, y: y + 8, x: x + 9] = o
    return imgs, segs


@pytest.mark.parametrize("v,id0,chunks", [(11, 0, 2), (3, 0, 1),
                                           (3, 20, 1)])
def test_per_view_prompts_match_jax(monkeypatch, extractors, v, id0,
                                    chunks):
    """DROPCLIP_PACKED_PROMPTS=0 (chunks of up to 8 views, each at the ids
    present anywhere in the scene) against the JAX per-view path at its
    default bucket: features within 1e-5 of max|ref| and present equal;
    the packed route gives the same rows. Ids from 20 on are in no view,
    so every row is zero."""
    jex, tex = extractors
    imgs, segs = _prompt_scene(np.random.RandomState(1), v=v)
    ids = np.arange(id0, id0 + 8)
    monkeypatch.setenv("DROPCLIP_PACKED_PROMPTS", "0")
    rf, rp = jex.extract_obj_prior(imgs, segs, obj_ids=ids)
    before = tex.chunks
    gf, gp = tex.extract_obj_prior(imgs, segs, obj_ids=ids)
    assert tex.chunks - before == chunks
    np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
    ref = np.asarray(rf)
    assert np.abs(gf.numpy() - ref).max() <= 1e-5 * max(np.abs(ref).max(),
                                                         1e-30)
    assert (gf.numpy()[~gp.numpy()] == 0).all()
    assert gp.numpy().any() == (id0 == 0)
    monkeypatch.setenv("DROPCLIP_PACKED_PROMPTS", "1")
    hf, hp = tex.extract_obj_prior(imgs, segs, obj_ids=ids)
    np.testing.assert_array_equal(hp.numpy(), gp.numpy())
    assert np.abs(hf.numpy() - gf.numpy()).max() <= 1e-5 * max(
        np.abs(ref).max(), 1e-30)


def test_on_device_gives_a_replica(extractors):
    """on_device copies the model to the device and shares the settings;
    the replica gives the same features."""
    _, tex = extractors
    rep = tex.on_device("cpu")
    assert rep.model is not tex.model and rep.img_resize == tex.img_resize
    imgs, segs = _prompt_scene(np.random.RandomState(2), v=3)
    a, _ = tex.extract_obj_prior(imgs, segs, obj_ids=np.arange(4))
    b, _ = rep.extract_obj_prior(imgs, segs, obj_ids=np.arange(4))
    assert torch.equal(a, b)
