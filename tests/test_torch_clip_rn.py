"""The ModifiedResNet (RN) CLIP towers: dropclip_tpu_torch.teachers.clip
against the JAX CLIP with the same weights, an OpenAI-layout RN file
drawn from a seed read by the JAX converter and carried across by
dropclip_tpu_torch.convert.clip_state_dict (so frozen BatchNorm statistics
and the attention pool are off their init values)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.teachers import clip as jclip
from dropclip_tpu.teachers import convert as jconvert
from dropclip_tpu_torch.convert import clip_state_dict
from dropclip_tpu_torch.teachers import clip, convert
from dropclip_tpu_torch.teachers.tokenizer import tokenize


def _pair(name, seed=1, **build):
    jp = jconvert.from_openai_state_dict(
        convert.synthetic_openai_state_dict(name, seed=seed))
    model = clip.build_clip(name, device="cpu", **build)
    model.load_state_dict(clip_state_dict(jp))
    return jclip.build_clip(name, use_flash=False), {"params": jp}, model


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny-test-rn")


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def test_encode_image_matches_jax(tiny):
    """The pooled features at the 64x64 training resolution (a 2x2 grid
    into the attention pool): within 1e-5 of max|ref|."""
    jm, jv, model = tiny
    px = np.random.RandomState(0).randn(3, 64, 64, 3).astype(np.float32)
    ref = jm.apply(jv, jnp.asarray(px), method="encode_image")
    with torch.no_grad():
        _close(model.encode_image(torch.as_tensor(px)), ref)


@pytest.mark.parametrize("hw", [(96, 160), (128, 128), (64, 64),
                                (100, 150)])
def test_patch_encodings_match_jax(tiny, hw):
    """MaskCLIP value-path features on non-square, larger, native and
    odd-sized inputs (the pools floor; the +0.1 bicubic pos-embed resize
    off the training grid): within 1e-5 of max|ref|."""
    jm, jv, model = tiny
    px = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    ref = jm.apply(jv, jnp.asarray(px), method="get_patch_encodings")
    with torch.no_grad():
        _close(model.get_patch_encodings(torch.as_tensor(px)), ref)


def test_encode_text_matches_jax(tiny):
    jm, jv, model = tiny
    toks = tokenize(["a red mug", "the green bowl on the table", "box"])
    ref = jm.apply(jv, jnp.asarray(toks), method="encode_text")
    with torch.no_grad():
        _close(model.encode_text(torch.as_tensor(toks)), ref)


def test_cls_path_needs_the_training_grid(tiny):
    jm, jv, model = tiny
    px = np.zeros((1, 96, 96, 3), np.float32)
    with pytest.raises(ValueError, match="training grid"):
        jm.apply(jv, jnp.asarray(px), method="encode_image")
    with pytest.raises(ValueError, match="training grid"):
        model.encode_image(torch.as_tensor(px))


def test_rn_state_dict_covers_every_parameter(tiny):
    _, jv, model = tiny
    sd = clip_state_dict(jax.tree_util.tree_map(np.asarray, jv["params"]))
    assert set(sd) == set(model.state_dict())
    assert sd["visual.conv1.weight"].shape == (8, 3, 3, 3)
    assert sd["visual.layer1_0.downsample_bn.var"].shape == (64,)
    assert isinstance(model.visual, clip.ModifiedResNet)


def test_bf16_towers_match_jax(tiny):
    """bf16 compute (the ingest policy: convs, linears and the stream in
    bf16, BatchNorm and softmax in float32): cosine >= 0.999 per row."""
    _, jv, _ = tiny
    jm = jclip.build_clip("tiny-test-rn", dtype=jnp.bfloat16,
                          use_flash=False)
    model = clip.build_clip("tiny-test-rn", dtype=torch.bfloat16,
                            device="cpu")
    model.load_state_dict(clip_state_dict(jv["params"]))
    assert model.visual.conv1.weight.dtype == torch.bfloat16
    assert model.visual.bn1.var.dtype == torch.float32
    px = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    for method in ("encode_image", "get_patch_encodings"):
        ref = np.asarray(jm.apply(jv, jnp.asarray(px), method=method),
                         np.float32).reshape(-1, 16)
        with torch.no_grad():
            got = getattr(model, method)(torch.as_tensor(px))
        got = got.float().numpy().reshape(-1, 16)
        cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1)
                                     * np.linalg.norm(ref, axis=-1))
        assert cos.min() >= 0.999, (method, cos.min())


@pytest.mark.slow
def test_rn50_full_width_matches_jax():
    """RN50 at full width (stages 3, 4, 6, 3; width 64; a 2048-d pool of
    32 heads) in float32: encode_image at 224x224 and the patch features at
    256x320, within 1e-4 of max|ref|."""
    jm, jv, model = _pair("RN50", seed=2)
    for hw, method, kw in (((224, 224), "encode_image", {}),
                           ((256, 320), "get_patch_encodings",
                            dict(patch_output=True))):
        px = np.random.RandomState(3).randn(1, *hw, 3).astype(np.float32)
        ref = jax.jit(lambda v, x: jm.apply(v, x, method=method))(
            jv, jnp.asarray(px))
        with torch.no_grad():
            _close(model.visual(torch.as_tensor(px), **kw), ref, rel=1e-4)
