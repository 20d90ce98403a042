"""Visual prompting and resizing: dropclip_tpu_torch.teachers.prompting
and ops.resize against the JAX package on the same numpy inputs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.ops import resize as jres
from dropclip_tpu.teachers import prompting as jp
from dropclip_tpu_torch.ops import resize as tres
from dropclip_tpu_torch.teachers import prompting as tp

H, W = 48, 64


def _scene(seed=0):
    rng = np.random.RandomState(seed)
    img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    masks = np.zeros((4, H, W), bool)
    masks[0, 5:20, 10:30] = True
    masks[1, 30:48, 40:64] = True  # touches the image border
    masks[2, 10:12, 3:50] = True   # wide and flat
    # masks[3] empty: box (0, 0, 1, 1)
    return img, masks


@pytest.mark.parametrize("kind", tp.PROMPT_KINDS)
def test_build_prompts_matches_jax(kind):
    """Every prompt kind at two crop levels, float32: within 2e-5 on the
    normalised values (bicubic taps summed in another order)."""
    img, masks = _scene()
    kw = dict(kinds=(kind,), crop_num_levels=2, crop_expansion_ratio=0.15,
              blur_kernel=7, out_hw=(32, 48))
    ref = np.asarray(jp.build_prompts(jnp.asarray(img), jnp.asarray(masks),
                                      **kw))
    got = tp.build_prompts(torch.as_tensor(img), torch.as_tensor(masks),
                           **kw).numpy()
    assert got.shape == ref.shape == (4, tp.num_prompts((kind,), 2), 32, 48,
                                      3)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_prompts_for_pairs_equal_per_image_prompts():
    """One image per mask (the extractor's packed pairs) gives what
    build_prompts gives each image alone."""
    img0, masks = _scene(0)
    img1, _ = _scene(1)
    imgs = torch.as_tensor(np.stack([img0, img1]))
    m = torch.as_tensor(masks[:2])
    both = tp.build_prompts(imgs, m, out_hw=(32, 48))
    for i in range(2):
        one = tp.build_prompts(imgs[i], m[i:i + 1], out_hw=(32, 48))
        torch.testing.assert_close(both[i:i + 1], one)


def test_box_helpers_match_jax():
    img, masks = _scene()
    for k in range(4):
        ref_box = np.asarray(jp.mask_to_box(jnp.asarray(masks[k])))
        got_box = tp.mask_to_box(torch.as_tensor(masks[k]))
        np.testing.assert_array_equal(got_box.numpy(), ref_box)
        for level in (0, 1, 3):
            np.testing.assert_array_equal(
                tp.expand_box(got_box, level, 0.15, (H, W)).numpy(),
                np.asarray(jp.expand_box(jnp.asarray(ref_box), level, 0.15,
                                         (H, W))))
        np.testing.assert_array_equal(
            tp.background_color(torch.as_tensor(img),
                                torch.as_tensor(masks[k])).numpy(),
            np.asarray(jp.background_color(jnp.asarray(img),
                                           jnp.asarray(masks[k]))))
    np.testing.assert_array_equal(tp.mask_to_box(torch.as_tensor(masks)),
                                  np.stack([np.asarray(jp.mask_to_box(
                                      jnp.asarray(m))) for m in masks]))


@pytest.mark.parametrize("box", [(10, 5, 30, 20), (0, 0, 64, 48),
                                 (3, 10, 50, 12), (40, 2, 44, 47)])
def test_crop_pad_resize_matches_jax(box):
    img, _ = _scene(2)
    bg = np.array([255.0, 255.0, 255.0], np.float32)
    ref = np.asarray(jp.crop_pad_resize(
        jnp.asarray(img, jnp.float32), jnp.asarray(box, jnp.int32),
        jnp.asarray(bg), (36, 48), W / H))
    got = tp.crop_pad_resize(
        torch.as_tensor(img, dtype=torch.float32)[None],
        torch.as_tensor(box, dtype=torch.int32)[None],
        torch.as_tensor(bg)[None], (36, 48), W / H)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("ksize", [3, 7, 41])
def test_gaussian_blur_matches_jax(ksize):
    """REFLECT_101 borders, float32 within 1e-3 on 0..255 values."""
    img, _ = _scene(3)
    ref = np.asarray(jp.gaussian_blur(jnp.asarray(img), ksize))
    got = tp.gaussian_blur(torch.as_tensor(img), ksize).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


def test_gray_and_normalize_match_jax():
    img, _ = _scene(4)
    x = img.astype(np.float32)
    np.testing.assert_allclose(
        tp.rgb_to_gray3(torch.as_tensor(x)).numpy(),
        np.asarray(jp.rgb_to_gray3(jnp.asarray(x))), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        tp.normalize(torch.as_tensor(x / 255)).numpy(),
        np.asarray(jp.normalize(jnp.asarray(x / 255))), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("out_hw,scale", [((336, 448), None),
                                          ((21, 28), None),
                                          ((24, 32), (24.1 / 24, 32.1 / 24)),
                                          ((10, 7), None)])
def test_resize_functions_match_jax(out_hw, scale):
    """bicubic_resize (with the scale override), bilinear_resize and
    resize_image, float32 within 1e-4 on 0..255 values."""
    img, _ = _scene(5)
    x = img.astype(np.float32)
    for name in ("bicubic_resize", "bilinear_resize"):
        ref = np.asarray(getattr(jres, name)(jnp.asarray(x), out_hw,
                                             scale_hw=scale))
        got = getattr(tres, name)(torch.as_tensor(x), out_hw,
                                  scale_hw=scale).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    ref = np.asarray(jp.resize_image(jnp.asarray(img), out_hw))
    got = tres.resize_image(torch.as_tensor(img), out_hw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    # channel-first planes
    ref = np.asarray(jres.bicubic_resize(jnp.asarray(x[..., 0]), out_hw,
                                         channel_last=False))
    got = tres.bicubic_resize(torch.as_tensor(x[..., 0]), out_hw,
                              channel_last=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_cubic_weights_match_jax():
    f = np.linspace(0, 1, 33, dtype=np.float32)
    np.testing.assert_allclose(
        tres._cubic_weights(torch.as_tensor(f)).numpy(),
        np.asarray(jres._cubic_weights(jnp.asarray(f))), rtol=1e-6,
        atol=1e-7)
