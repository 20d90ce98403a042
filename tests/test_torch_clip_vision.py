"""CLIP vision tower: dropclip_tpu_torch.teachers.clip against the JAX
CLIP with the same weights (JAX init carried across by
dropclip_tpu_torch.convert), with the fused residual stream off and on."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.teachers import clip as jclip
from dropclip_tpu_torch.convert import clip_state_dict, clip_vision_state_dict
from dropclip_tpu_torch.teachers.clip import (CLIP, CLIP_CONFIGS,
                                              CLIPVisionTransformer,
                                              build_clip)


@pytest.fixture(scope="module")
def tiny():
    clip = jclip.build_clip("tiny-test", use_flash=False)
    r = clip.image_resolution
    cvars = jax.jit(lambda p, t: clip.init(jax.random.PRNGKey(2), p, t))(
        jnp.zeros((1, r, r, 3)), jnp.zeros((1, 77), jnp.int32))
    model = build_clip("tiny-test", device="cpu")
    model.load_state_dict(clip_state_dict(
        jax.tree_util.tree_map(np.asarray, cvars["params"])))
    return clip, cvars, model


@pytest.mark.parametrize("fused", [None, "1", "0"])
@pytest.mark.parametrize("method", ["encode_image", "get_patch_encodings"])
def test_tiny_vit_matches_jax(tiny, monkeypatch, fused, method):
    """float32, a non-square 48x64 input (pos-embed interpolated to a 3x4
    grid): within 1e-5. The port always runs the fused residual stream;
    DROPCLIP_FUSED_ADD_LN selects the JAX package's form (unfused unless
    set to 1), and both JAX forms are the same arithmetic."""
    clip, cvars, model = tiny
    if fused is None:
        monkeypatch.delenv("DROPCLIP_FUSED_ADD_LN", raising=False)
    else:
        monkeypatch.setenv("DROPCLIP_FUSED_ADD_LN", fused)
    px = np.random.RandomState(0).randn(3, 48, 64, 3).astype(np.float32)
    ref = np.asarray(clip.apply(cvars, jnp.asarray(px), method=method))
    with torch.no_grad():
        got = getattr(model, method)(torch.as_tensor(px)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_patch_conv_same_padding(tiny):
    """An input that is not a multiple of the patch (40x50, patch 16):
    the flax Conv's SAME padding, here zero padding before unfolding."""
    clip, cvars, model = tiny
    px = np.random.RandomState(1).randn(2, 40, 50, 3).astype(np.float32)
    ref = np.asarray(clip.apply(cvars, jnp.asarray(px),
                                method="get_patch_encodings"))
    with torch.no_grad():
        got = model.get_patch_encodings(torch.as_tensor(px)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_pos_embed_interpolation_matches_jax(tiny):
    """Bicubic (a = -0.75) with the +0.1 scale trick, to grids above and
    below the 2x2 training grid: within 1e-6."""
    clip, cvars, model = tiny
    for gh, gw in ((3, 4), (21, 28), (1, 2), (2, 2)):
        ref = np.asarray(clip.apply(
            cvars, gh, gw,
            method=lambda m, a, b: m.visual._interpolated_pos_embed(a, b)))
        got = model.visual._interpolated_pos_embed(gh, gw).detach().numpy()
        assert got.shape == (gh * gw + 1, 64)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_vit_l14_336_two_layers_full_width():
    """ViT-L/14@336px at full width (1024, 16 heads of 64), cut to two
    blocks, on two 336x448 crops (T = 24*32 + 1 = 769, the ingest shape;
    the port routes it through K3's plain version): float32 class-token
    and patch features within 1e-4 of max|ref|."""
    cfg = CLIP_CONFIGS["ViT-L/14@336px"]
    kw = dict(width=cfg["vision_width"], layers=2, heads=16,
              patch_size=cfg["vision_patch_size"],
              embed_dim=cfg["embed_dim"],
              image_resolution=cfg["image_resolution"])
    jv = jclip.CLIPVisionTransformer(**kw)
    jvars = jax.jit(jv.init)(jax.random.PRNGKey(3),
                             jnp.zeros((1, 336, 336, 3)))
    tv = CLIPVisionTransformer(**kw)
    tv.load_state_dict(clip_vision_state_dict(
        jax.tree_util.tree_map(np.asarray, jvars["params"])))
    px = np.random.RandomState(4).randn(2, 336, 448, 3).astype(np.float32)
    for patch in (False, True):
        ref = np.asarray(jax.jit(lambda v, x: jv.apply(
            v, x, patch_output=patch))(jvars, jnp.asarray(px)))
        with torch.no_grad():
            got = tv(torch.as_tensor(px), patch_output=patch).numpy()
        assert got.shape == ((2, 768, 768) if patch else (2, 768))
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_clip_state_dict_covers_every_parameter(tiny):
    clip, cvars, model = tiny
    sd = clip_state_dict(jax.tree_util.tree_map(np.asarray,
                                                cvars["params"]))
    assert set(sd) == set(model.state_dict())
    assert sd["visual.conv1.weight"].shape == (64, 16 * 16 * 3)
    rn = CLIP(**CLIP_CONFIGS["tiny-test-rn"])  # the RN tower builds too
    assert not any(k.startswith("visual.blocks.") for k in rn.state_dict())
