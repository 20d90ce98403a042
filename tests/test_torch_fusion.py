"""Multi-view fusion: dropclip_tpu_torch.fusion.core against
dropclip_tpu.fusion.core on the same numpy inputs. Object-level fusion
with padded object sets, both similarity kernels and the NaN rows of
never-fused objects; point-level fusion with the bicubic sampling of
teacher patch maps at the projected pixels (``bicubic_sample_at``)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dropclip_tpu.data.synthetic import make_raw_scene
from dropclip_tpu.fusion import core as jf
from dropclip_tpu.ops.resize import bicubic_sample_at as jsample
from dropclip_tpu_torch.fusion import core as tf
from dropclip_tpu_torch.ops.resize import bicubic_resize, bicubic_sample_at


def _inputs(q_pad=8, n_real=4, c=16, seed=0):
    raw = make_raw_scene(np.random.default_rng(seed), n_objects=n_real - 1,
                         n_views=4)
    rng = np.random.RandomState(seed)
    v = raw["depths"].shape[0]
    feats = rng.randn(v, q_pad, c).astype(np.float32)
    present = rng.rand(v, q_pad) > 0.3
    present[:, 0] = False   # the table is never prompted
    present[:, 2] = False   # object 2 seen in no view -> NaN row
    feats[~present] = 0.0
    queries = rng.randn(q_pad, c).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    obj_valid = np.arange(q_pad) < n_real
    return raw, feats, present, queries, obj_valid


@pytest.mark.parametrize("sim_kernel", ["max", "mean"])
@pytest.mark.parametrize("use_visibility", [False, True])
@pytest.mark.parametrize("use_similarity", [False, True])
def test_fuse_obj_prior_matches_jax(sim_kernel, use_visibility,
                                    use_similarity):
    """Fused features and weights within 1e-5 (NaN rows in the same
    places), visibility equal."""
    raw, feats, present, queries, obj_valid = _inputs()
    pts = raw["points"]
    cfg_kw = dict(image_hw=raw["depths"].shape[1:], use_visibility=
                  use_visibility, use_similarity=use_similarity,
                  sim_kernel=sim_kernel)
    args = (pts, raw["depths"], raw["segs"], raw["poses"], feats, present,
            queries, raw["K"])
    ref = jf.fuse_obj_prior(*map(jnp.asarray, args),
                            jf.FusionConfig(**cfg_kw),
                            obj_valid=jnp.asarray(obj_valid))
    got = tf.fuse_obj_prior(*map(torch.as_tensor, args),
                            tf.FusionConfig(**cfg_kw),
                            obj_valid=torch.as_tensor(obj_valid))
    ref_f = np.asarray(ref.obj_features)
    got_f = got.obj_features.numpy()
    np.testing.assert_array_equal(np.isnan(got_f), np.isnan(ref_f))
    assert np.isnan(got_f[2]).all() and np.isnan(got_f[0]).all()
    assert np.isnan(got_f[~obj_valid]).all()  # padded rows: weight 0
    np.testing.assert_allclose(got_f, ref_f, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.visibility.numpy(),
                                  np.asarray(ref.visibility))
    np.testing.assert_array_equal(got.visible.numpy(),
                                  np.asarray(ref.visible))
    assert got.visible.any()


def test_padding_does_not_change_real_rows():
    """The same objects padded to 8 and to 32 rows: equal real rows."""
    raw, feats, present, queries, obj_valid = _inputs(q_pad=8)
    pad = 32 - 8
    feats32 = np.concatenate([feats, np.zeros((4, pad, 16), np.float32)], 1)
    present32 = np.concatenate([present, np.zeros((4, pad), bool)], 1)
    q32 = np.concatenate([queries, np.tile(queries[:1], (pad, 1))])
    cfg = tf.FusionConfig(image_hw=raw["depths"].shape[1:],
                          use_visibility=False)
    run = lambda f, p, q, valid: tf.fuse_obj_prior(
        *map(torch.as_tensor, (raw["points"], raw["depths"], raw["segs"],
                               raw["poses"], f, p, q, raw["K"])), cfg,
        obj_valid=torch.as_tensor(valid)).obj_features[:4].numpy()
    np.testing.assert_allclose(
        run(feats, present, queries, obj_valid),
        run(feats32, present32, q32, np.arange(32) < 4), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("kernel", ["max", "mean"])
def test_relative_similarity_matches_jax(kernel):
    rng = np.random.RandomState(1)
    pos = rng.randn(10).astype(np.float32)
    neg = rng.randn(10, 5).astype(np.float32)
    np.testing.assert_allclose(
        tf.relative_similarity(torch.as_tensor(pos), torch.as_tensor(neg),
                               kernel).numpy(),
        np.asarray(jf.relative_similarity(jnp.asarray(pos),
                                          jnp.asarray(neg), kernel)),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tf.relative_similarity(torch.as_tensor(pos), torch.as_tensor(neg),
                               "median")


def test_splat_object_features_matches_jax():
    labels = np.array([0, 1, 2, 3, 7, -1, 2], np.int32)
    feats = np.random.RandomState(2).randn(4, 6).astype(np.float32)
    np.testing.assert_array_equal(
        tf.splat_object_features(torch.as_tensor(labels),
                                 torch.as_tensor(feats)).numpy(),
        np.asarray(jf.splat_object_features(jnp.asarray(labels),
                                            jnp.asarray(feats))))


@pytest.mark.parametrize("src_hw,out_hw", [((7, 9), (48, 64)),
                                           ((24, 32), (480, 640)),
                                           ((5, 5), (5, 5))])
def test_bicubic_sample_at_matches_jax(src_hw, out_hw):
    """Within 1e-6 of the JAX function and of the full bicubic resize read
    at the same pixels (every pixel of the border rows and columns, the
    rest at random)."""
    rng = np.random.default_rng(0)
    src = rng.standard_normal((*src_hw, 6)).astype(np.float32)
    h, w = out_hw
    border = np.array([(y, x) for y in range(h) for x in range(w)
                       if y in (0, h - 1) or x in (0, w - 1)])
    pts = np.concatenate([border, np.stack(
        [rng.integers(0, h, 300), rng.integers(0, w, 300)], -1)])
    py, px = pts[:, 0], pts[:, 1]
    got = bicubic_sample_at(torch.as_tensor(src), out_hw,
                            torch.as_tensor(px), torch.as_tensor(py)).numpy()
    ref = np.asarray(jsample(jnp.asarray(src), out_hw, jnp.asarray(px),
                             jnp.asarray(py)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    full = bicubic_resize(torch.as_tensor(src), out_hw).numpy()[py, px]
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-5)
    assert got.dtype == np.float32


@pytest.mark.parametrize("sim_kernel", ["max", "mean"])
@pytest.mark.parametrize("use_similarity", [False, True])
def test_fuse_points_matches_jax(sim_kernel, use_similarity):
    """Fused point features within 1e-5 (NaN rows, the points seen in no
    view, in the same places), per-view visibility equal, similarity
    weights within 1e-5; ``fuse`` dispatches to it."""
    raw, *_ = _inputs()
    rng = np.random.RandomState(3)
    v = raw["depths"].shape[0]
    patch = rng.randn(v, 4, 5, 16).astype(np.float32)
    q = rng.randn(8, 16).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    kw = dict(image_hw=raw["depths"].shape[1:], use_similarity=use_similarity,
              sim_kernel=sim_kernel)
    args = (raw["points"], raw["depths"], raw["segs"], raw["poses"], patch,
            q, raw["K"])
    ref = jf.fuse_points(*map(jnp.asarray, args), jf.FusionConfig(**kw))
    got = tf.fuse(*map(torch.as_tensor, args), tf.FusionConfig(**kw),
                  use_obj_prior=False)
    ref_f, got_f = np.asarray(ref.features), got.features.numpy()
    np.testing.assert_array_equal(np.isnan(got_f), np.isnan(ref_f))
    assert 0 < np.isnan(got_f).any(-1).sum() < len(got_f)
    np.testing.assert_allclose(got_f, ref_f, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.visibility.numpy(),
                                  np.asarray(ref.visibility))
    np.testing.assert_array_equal(got.visible.numpy(),
                                  np.asarray(ref.visible))
    np.testing.assert_allclose(got.similarity.numpy(),
                               np.asarray(ref.similarity), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        tf.fuse_points(*map(torch.as_tensor, args[:5]), None,
                       torch.as_tensor(raw["K"]), tf.FusionConfig())
