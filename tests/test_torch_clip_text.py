"""CLIP text tower: dropclip_tpu_torch.teachers.clip against the JAX
CLIP.encode_text with the same weights (JAX init of the tiny-test config,
carried across by dropclip_tpu_torch.convert)."""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.teachers.clip import build_clip
from dropclip_tpu.teachers.tokenizer import tokenize
from dropclip_tpu_torch.convert import clip_text_state_dict
from dropclip_tpu_torch.teachers.clip import build_clip_text, quick_gelu

PROMPTS = ["the red mug", "a bowl", "object", "thing", "texture", "stuff",
           "a very long prompt about a small blue ceramic cup on the left"]


def _jax_clip():
    clip = build_clip("tiny-test", use_flash=False)
    toks = jnp.zeros((1, clip.context_length), jnp.int32)
    px = jnp.zeros((1, clip.image_resolution, clip.image_resolution, 3))
    cvars = jax.jit(lambda p, t: clip.init(jax.random.PRNGKey(1), p, t))(
        px, toks)
    return clip, cvars


def test_encode_text_matches_jax():
    """f32 both sides: pooled, projected embeddings within 1e-5."""
    clip, cvars = _jax_clip()
    toks = tokenize(PROMPTS)
    ref = np.asarray(jax.jit(lambda v, t: clip.apply(
        v, t, method="encode_text"))(cvars, jnp.asarray(toks)))
    model = build_clip_text("tiny-test")
    model.load_state_dict(clip_text_state_dict(
        jax.tree_util.tree_map(np.asarray, cvars["params"]["text"])))
    with torch.no_grad():
        got = model(torch.as_tensor(toks)).numpy()
    assert got.shape == ref.shape == (len(PROMPTS), 16)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_bf16_tower_tracks_f32():
    """The serve policy (bf16 linears/stream, f32 LayerNorm and softmax)
    stays close to the f32 tower: cosine > 0.99 per prompt."""
    gen = lambda: torch.Generator().manual_seed(3)
    f32 = build_clip_text("tiny-test", generator=gen())
    bf16 = build_clip_text("tiny-test", dtype=torch.bfloat16,
                           generator=gen())
    toks = torch.as_tensor(tokenize(PROMPTS))
    with torch.no_grad():
        a, b = f32(toks), bf16(toks).float()
    assert bf16.blocks[0].c_fc.weight.dtype == torch.bfloat16
    assert bf16.ln_final.scale.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    assert (cos > 0.99).all(), cos


def test_quick_gelu_matches_jax():
    from dropclip_tpu.teachers.clip import quick_gelu as jq

    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(quick_gelu(torch.as_tensor(x)).numpy(),
                               np.asarray(jq(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)
