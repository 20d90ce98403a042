"""The slice as a whole: the JAX GroundingPipeline (built as in
tests/test_pipeline.py) against dropclip_tpu_torch's, same weights, same
clouds, on the CPU (the port's entry points with device="cpu")."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.pipeline import GroundingPipeline as JPipe
from dropclip_tpu_torch.convert import clip_text_state_dict
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.pipeline import GroundingPipeline
from dropclip_tpu_torch.similarity import ClipSimilarity
from dropclip_tpu_torch.teachers.clip import build_clip_text

CFG = dict(arch_3d="tiny", feat_dim=16, voxel_capacity=128, voxel_size=0.05,
           use_color=True, sparse_backend="bricks", brick_shape=[4, 4, 2],
           sim_method="paired", sim_norm_thresh=0.6)
QUERIES = ["the red mug", "a bowl"]


@pytest.fixture(scope="module")
def pipes():
    from dropclip_tpu.distill.engine import build_student_for, build_topology
    from dropclip_tpu.similarity import ClipSimilarity as JSim
    from dropclip_tpu.teachers.clip import build_clip

    cfg = JCfg(dict(CFG))
    model = build_student_for(cfg)
    coords = jnp.zeros((1, 128, 3), jnp.int32)
    mask = jnp.zeros((1, 128), bool).at[:, :16].set(True)
    topo = build_topology(cfg, coords, mask)
    variables = jax.jit(lambda t, f: model.init(
        jax.random.PRNGKey(0), t, f, train=False))(
        topo, jnp.zeros((1, 128, 6), jnp.float32))
    clip = build_clip("tiny-test", use_flash=False)
    toks = jnp.zeros((1, clip.context_length), jnp.int32)
    px = jnp.zeros((1, clip.image_resolution, clip.image_resolution, 3))
    cvars = jax.jit(lambda p, t: clip.init(jax.random.PRNGKey(1), p, t)
                    )(px, toks)
    jpipe = JPipe(cfg, variables["params"], variables.get("batch_stats", {}),
                  JSim(clip, cvars, threshold=0.6))

    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    text = build_clip_text("tiny-test")
    text.load_state_dict(clip_text_state_dict(
        np_tree(cvars["params"]["text"])))
    tpipe = GroundingPipeline(
        CfgNode(dict(CFG)), np_tree(variables["params"]),
        np_tree(variables.get("batch_stats", {})),
        ClipSimilarity(text, "cpu"), device="cpu")
    return jpipe, tpipe


def _assert_grounding_equal(m_t, s_t, m_j, s_j, thr=0.6):
    """sims within 1e-5; masks equal except points whose sim lies within
    1e-5 of the threshold (they may flip on summation order)."""
    s_t, s_j = np.asarray(s_t), np.asarray(s_j)
    np.testing.assert_allclose(s_t, s_j, atol=1e-5, rtol=0)
    assert m_t.shape == np.asarray(m_j).shape


def test_ground_matches_jax(pipes, rng):
    jpipe, tpipe = pipes
    for _ in range(2):
        xyz = rng.randn(300, 3).astype(np.float32) * 0.3
        rgb = rng.rand(300, 3)
        m_j, s_j = jpipe.ground(xyz, rgb, QUERIES)
        m_t, s_t = tpipe.ground(xyz, rgb, QUERIES)
        assert tpipe.last_dropped == jpipe.last_dropped
        _assert_grounding_equal(m_t, s_t, m_j, s_j)
        # per-voxel masks: equal away from the threshold
        vm_j, vs_j = jpipe.ground(xyz, rgb, QUERIES, per_point=False)
        vm_t, vs_t = tpipe.ground(xyz, rgb, QUERIES, per_point=False)
        near = np.abs(np.asarray(vs_j) - 0.6) < 1e-5
        np.testing.assert_array_equal(vm_t[~near], np.asarray(vm_j)[~near])
        # per-point masks follow the voxel masks through the inverse map
        far_pts = ~near[:, np.maximum(
            tpipe._host_voxelize(xyz, rgb)[0].inverse_map, 0)]
        np.testing.assert_array_equal(m_t[far_pts], np.asarray(m_j)[far_pts])


def test_ground_argmax_and_custom_negatives_match_jax(pipes, rng):
    jpipe, tpipe = pipes
    xyz = rng.randn(300, 3).astype(np.float32) * 0.3
    negs = ["table", "wall", "floor"]
    m_j, s_j = jpipe.ground(xyz, None, QUERIES, negatives=negs,
                            threshold=0.5)
    m_t, s_t = tpipe.ground(xyz, None, QUERIES, negatives=negs,
                            threshold=0.5)
    _assert_grounding_equal(m_t, s_t, m_j, s_j)
    jpipe.cfg.sim_method = tpipe.cfg.sim_method = "argmax"
    try:
        m_j, s_j = jpipe.ground(xyz, None, QUERIES)
        m_t, s_t = tpipe.ground(xyz, None, QUERIES)
    finally:
        jpipe.cfg.sim_method = tpipe.cfg.sim_method = "paired"
    _assert_grounding_equal(m_t, s_t, m_j, s_j)
    np.testing.assert_array_equal(m_t, m_j)


def test_ground_batch_equals_per_scene_ground(pipes, rng):
    _, tpipe = pipes
    clouds = [rng.randn(n, 3).astype(np.float32) * 0.3
              for n in (300, 200, 260)]
    rgbs = [rng.rand(len(c), 3) for c in clouds]
    masks, sims = tpipe.ground_batch(clouds, rgbs, QUERIES)
    assert len(masks) == 3 and sims.shape == (3, 2, 128)
    for i, (c, r) in enumerate(zip(clouds, rgbs)):
        m_ref, s_ref = tpipe.ground(c, r, QUERIES)
        np.testing.assert_array_equal(masks[i], m_ref)
        np.testing.assert_allclose(sims[i], s_ref, atol=1e-5, rtol=0)
    vm, vs = tpipe.ground_batch(clouds, None, ["thing"], per_point=False)
    assert vm.shape == vs.shape == (3, 1, 128)


def test_ground_batch_matches_jax(pipes, rng):
    jpipe, tpipe = pipes
    clouds = [rng.randn(300, 3).astype(np.float32) * 0.3 for _ in range(2)]
    m_j, s_j = jpipe.ground_batch(clouds, None, QUERIES, per_point=False)
    m_t, s_t = tpipe.ground_batch(clouds, None, QUERIES, per_point=False)
    np.testing.assert_allclose(s_t, np.asarray(s_j), atol=1e-5, rtol=0)
    near = np.abs(np.asarray(s_j) - 0.6) < 1e-5
    np.testing.assert_array_equal(m_t[~near], np.asarray(m_j)[~near])


def test_featurize_shapes_and_padding(pipes, rng):
    _, tpipe = pipes
    xyz = rng.randn(80, 3).astype(np.float32) * 0.3
    feats, vmask, _ = tpipe.featurize(xyz, rng.rand(80, 3))
    assert tuple(feats.shape) == (128, 16) and feats.device.type == "cpu"
    assert 10 < vmask.sum() < 128
    assert float(feats[torch.as_tensor(~vmask)].abs().max()) == 0.0


def _volumetric_cloud(seed, n_occ=90):
    """A bin-like cloud: make_volumetric_coords voxels at 5 cm, one
    jittered point per voxel plus a second for half of them."""
    from dropclip_tpu_torch.data.synthetic import make_volumetric_coords

    rng = np.random.RandomState(seed)
    coords, mask = make_volumetric_coords(rng, 1, 128, n_occ=n_occ, ext=7,
                                          zext=12)
    c = coords[0][mask[0]].astype(np.float32)
    c = np.concatenate([c, c[: len(c) // 2]])
    xyz = ((c + rng.rand(*c.shape)) * 0.05).astype(np.float32)
    return xyz, rng.rand(len(xyz), 3).astype(np.float32)


@pytest.fixture(scope="module")
def pillar_pipes(pipes):
    jpipe, tpipe = pipes
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    jp = JPipe(JCfg(dict(CFG)), jpipe.variables["params"],
               jpipe.variables["batch_stats"], jpipe.clip_sim,
               engine="pillars")
    tp = GroundingPipeline(
        CfgNode(dict(CFG, sparse_backend="pillars")),
        np_tree(jpipe.variables["params"]),
        np_tree(jpipe.variables["batch_stats"]), tpipe.clip_sim,
        device="cpu")
    assert tp.engine == "pillars"
    return jp, tp


def test_pillar_ground_matches_jax(pillar_pipes):
    """engine="pillars" against the JAX pipeline's: sims within 1e-5,
    masks equal away from the threshold; the second cloud replays the
    static shapes fitted on the first, as in JAX."""
    jp, tp = pillar_pipes
    shapes = None
    for seed in (11, 12):
        xyz, rgb = _volumetric_cloud(seed)
        vm_j, vs_j = jp.ground(xyz, rgb, QUERIES, per_point=False)
        vm_t, vs_t = tp.ground(xyz, rgb, QUERIES, per_point=False)
        assert tp.last_dropped == jp.last_dropped == 0
        assert (tp.pillar_z0, tp.pillar_caps) == (jp._pillar_z0,
                                                  jp._pillar_caps)
        shapes = shapes or (tp.pillar_z0, list(tp.pillar_caps))
        assert (tp.pillar_z0, tp.pillar_caps) == shapes
        np.testing.assert_allclose(vs_t, np.asarray(vs_j), atol=1e-5,
                                   rtol=0)
        near = np.abs(np.asarray(vs_j) - 0.6) < 1e-5
        np.testing.assert_array_equal(vm_t[~near], np.asarray(vm_j)[~near])
        m_j, _ = jp.ground(xyz, rgb, QUERIES)
        m_t, _ = tp.ground(xyz, rgb, QUERIES)
        far_pts = ~near[:, np.maximum(
            tp._host_voxelize(xyz, rgb)[0].inverse_map, 0)]
        np.testing.assert_array_equal(m_t[far_pts], np.asarray(m_j)[far_pts])
    assert tp.forwards == 4


def test_pillar_engine_refusals_and_empty_cloud(pillar_pipes):
    """ground_batch refuses the pillar engine, as in JAX; an empty cloud
    gives empty masks (the JAX builder asserts); a cloud taller than the
    frozen pillar_z0 raises a ValueError that names it."""
    _, tp = pillar_pipes
    xyz, rgb = _volumetric_cloud(13)
    with pytest.raises(ValueError, match="per scene"):
        tp.ground_batch([xyz], [rgb], QUERIES)
    masks, _ = tp.ground(np.zeros((0, 3), np.float32), None, QUERIES)
    assert masks.shape == (2, 0)
    vm, _ = tp.ground(xyz[:1] * 0, None, QUERIES[:1], per_point=False)
    assert vm.shape == (1, 128)
    tall = np.concatenate([xyz, xyz[:4] + np.array([0, 0, 5.0],
                                                   np.float32)])
    with pytest.raises(ValueError, match="pillar_z0"):
        tp.ground(tall, None, QUERIES)


def test_from_checkpoint_round_trips_the_trainers_checkpoint(tmp_path, rng):
    """A checkpoint of the port's trainer (one epoch of the tiny student,
    best_sim_loss_model by default) and a CLIP checkpoint file through
    GroundingPipeline.from_checkpoint: the student's state dict as saved,
    and ground() within 1e-6 relative of a pipeline built in process from
    the same state dict and text tower."""
    import os

    from dropclip_tpu_torch.core.checkpoint import restore_checkpoint
    from dropclip_tpu_torch.core.config import load_cfg, merge_cfg_from_list
    from dropclip_tpu_torch.data.synthetic import \
        write_fake_processed_dataset
    from dropclip_tpu_torch.pipeline import make_clip_sim
    from dropclip_tpu_torch.teachers.convert import \
        synthetic_openai_state_dict
    from dropclip_tpu_torch.tools import train_distil

    yaml = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "DistilBlender.yaml")
    data, clip = str(tmp_path / "data"), str(tmp_path / "clip.pt")
    write_fake_processed_dataset(data, n_scenes=2, n_objects=2, feat_dim=16,
                                 fmt="npz")
    torch.save(synthetic_openai_state_dict("tiny-test", seed=6), clip)
    shape = ["arch_3d", "tiny", "feat_dim", "16", "voxel_capacity", "256",
             "voxel_size", "0.02", "clip_model", "tiny-test",
             "sim_norm_thresh", "0.6"]
    save = train_distil.main(
        ["--config", yaml, "--device", "cpu", "--opts", "root_dir", data,
         *shape, "batch_size", "2", "batch_size_val", "2", "workers", "1",
         "workers_val", "1", "epochs", "1", "save_path",
         str(tmp_path / "exp")])
    pipe = GroundingPipeline.from_checkpoint(
        yaml, save, clip_checkpoint=clip, overrides=shape, device="cpu")
    saved = restore_checkpoint(save, name="best_sim_loss_model")["model"]
    got_sd = pipe.model.state_dict()
    assert set(got_sd) == set(saved)
    assert all(torch.equal(got_sd[k], saved[k]) for k in saved)

    cfg = merge_cfg_from_list(load_cfg(yaml), shape)
    cfg.clip_checkpoint = clip
    ref = GroundingPipeline(cfg, clip_sim=make_clip_sim(cfg, "cpu"),
                            device="cpu")
    ref.model.load_state_dict(saved)
    for _ in range(2):
        xyz = rng.randn(300, 3).astype(np.float32) * 0.3
        rgb = rng.rand(300, 3)
        m_g, s_g = pipe.ground(xyz, rgb, QUERIES)
        m_r, s_r = ref.ground(xyz, rgb, QUERIES)
        assert np.abs(s_g - s_r).max() <= 1e-6 * max(np.abs(s_r).max(), 1e-6)
        np.testing.assert_array_equal(m_g, m_r)
    with pytest.raises(FileNotFoundError):
        GroundingPipeline.from_checkpoint(yaml, str(tmp_path), clip,
                                          overrides=shape, device="cpu")
    with pytest.raises(ValueError, match="clip_checkpoint"):
        GroundingPipeline.from_checkpoint(yaml, save, overrides=shape,
                                          device="cpu")


def test_gather_engine_refusals_name_their_item():
    """The gather engine, refused until its ROADMAP item (queue 1 item
    7.2) was ported, now builds in the pipeline and the engine; what is
    still refused is an engine the port does not have, named with the
    ones it has."""
    from dropclip_tpu_torch.distill import engine
    from dropclip_tpu_torch.sparse.unet import MinkUNet

    cfg = CfgNode(dict(arch_3d="tiny", feat_dim=8, voxel_capacity=64,
                       sparse_backend="gather", clip_checkpoint="random",
                       clip_model="tiny-test"))
    assert isinstance(GroundingPipeline(cfg, device="cpu").model, MinkUNet)
    assert isinstance(engine.build_student_for(cfg), MinkUNet)
    bad = CfgNode(dict(cfg, sparse_backend="voxels"))
    for refuse in (lambda: GroundingPipeline(bad, device="cpu"),
                   lambda: engine.build_student_for(bad)):
        with pytest.raises(ValueError, match="gather"):
            refuse()
