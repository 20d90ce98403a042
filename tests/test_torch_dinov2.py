"""DINOv2: dropclip_tpu_torch.teachers.dinov2 against the JAX DINOv2 with
the same weights (a JAX init carried across by
dropclip_tpu_torch.convert.dinov2_state_dict, or a HuggingFace-layout file
read by both converters), and the attention route of the port's teachers
against the JAX predicates."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.teachers import dinov2 as jdinov2
from dropclip_tpu_torch.convert import dinov2_state_dict
from dropclip_tpu_torch.ops import attention as att
from dropclip_tpu_torch.teachers import dinov2

TINY = dict(width=64, layers=2, heads=4, image_resolution=28)


def jax_tiny(ffn, seed=1):
    """A JAX tiny DINOv2 with LayerScale and LayerNorms moved off their
    init values; its numpy tree."""
    model = jdinov2.DinoV2ViT(ffn=ffn, **TINY)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 3)))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    rs = np.random.RandomState(seed)
    for i in range(TINY["layers"]):
        blk = params[f"block_{i}"]
        blk["ls1"] = blk["ls1"] * 0.7 + 0.1 * rs.randn(64).astype(np.float32)
        blk["ls2"] = blk["ls2"] * 1.3
        blk["norm2"]["scale"] = blk["norm2"]["scale"] + 0.1 * rs.randn(
            64).astype(np.float32)
    params["cls_token"] = 0.02 * rs.randn(1, 1, 64).astype(np.float32)
    return model, {"params": params}, params


def port_model(params, ffn, dtype=torch.float32):
    model = dinov2.build_dinov2("tiny-test", dtype=dtype, device="cpu",
                                ffn=ffn)
    model.load_state_dict(dinov2_state_dict(params))
    return model


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("fused", [None, "1"])
@pytest.mark.parametrize("hw", [(28, 28), (42, 56)])
@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_tiny_matches_jax(monkeypatch, ffn, hw, fused):
    """float32 cls and patch tokens within 1e-5 of max|ref|, at the
    training grid and at a non-square one (bicubic pos-embed resize). The
    port always runs the fused residual stream; DROPCLIP_FUSED_ADD_LN
    selects the JAX package's form, the same arithmetic."""
    if fused is None:
        monkeypatch.delenv("DROPCLIP_FUSED_ADD_LN", raising=False)
    else:
        monkeypatch.setenv("DROPCLIP_FUSED_ADD_LN", fused)
    jm, jv, params = jax_tiny(ffn)
    px = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    rc, rp = jm.apply(jv, jnp.asarray(px))
    with torch.no_grad():
        gc, gp = port_model(params, ffn)(torch.as_tensor(px))
    assert gc.dtype == gp.dtype == torch.float32
    _close(gc.numpy(), rc)
    _close(gp.numpy(), rp)


def test_same_padding_patch_embed_matches_jax():
    """An input that is not a multiple of the patch (30x45): the flax
    Conv's SAME padding."""
    jm, jv, params = jax_tiny("mlp")
    px = np.random.RandomState(2).randn(1, 30, 45, 3).astype(np.float32)
    rc, rp = jm.apply(jv, jnp.asarray(px))
    with torch.no_grad():
        gc, gp = port_model(params, "mlp")(torch.as_tensor(px))
    _close(gc.numpy(), rc)
    _close(gp.numpy(), rp)


def test_state_dict_covers_every_parameter():
    for ffn in ("mlp", "swiglu"):
        _, _, params = jax_tiny(ffn)
        sd = dinov2_state_dict(params)
        model = dinov2.build_dinov2("tiny-test", device="cpu", ffn=ffn)
        assert set(sd) == set(model.state_dict())
        assert sd["patch_embed.weight"].shape == (64, 3, 14, 14)


@pytest.mark.parametrize("mode", ["cls", "patch"])
def test_extractor_matches_jax(mode):
    """Dinov2Extractor on uint8 frames (resize, DINO normalisation,
    batches of 3 over 5 frames): float32 within 1e-5 of max|ref|."""
    jm, jv, params = jax_tiny("mlp")
    frames = (np.random.RandomState(3).rand(5, 40, 52, 3) * 255).astype(
        np.uint8)
    ref = jdinov2.Dinov2Extractor(jm, jv, mode=mode, img_resize=(28, 42),
                                  batch_size=3).extract(frames)
    ex = dinov2.Dinov2Extractor(port_model(params, "mlp"), mode=mode,
                                img_resize=(28, 42), batch_size=3)
    _close(ex.extract(frames).numpy(), ref)
    with pytest.raises(ValueError):
        ex.set_mode("dense")


def test_bf16_extractor_matches_jax():
    """Both packages in bf16 (the dino_extract policy): the float32
    outputs of the final LayerNorm at cosine >= 0.999 per token."""
    _, _, params = jax_tiny("swiglu")
    jm = jdinov2.DinoV2ViT(ffn="swiglu", dtype=jnp.bfloat16, **TINY)
    frames = (np.random.RandomState(4).rand(2, 40, 52, 3) * 255).astype(
        np.uint8)
    ref = np.asarray(jdinov2.Dinov2Extractor(
        jm, {"params": params}, img_resize=(28, 42)).extract(frames))
    got = dinov2.Dinov2Extractor(
        port_model(params, "swiglu", torch.bfloat16),
        img_resize=(28, 42)).extract(frames)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    got, ref = got.numpy().reshape(-1, 64), ref.reshape(-1, 64)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1)
                                 * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.999, cos.min()


def test_hf_file_reads_into_both_packages():
    """A HuggingFace-layout state dict drawn from a seed: the port's
    from_hf_dinov2 equals the JAX converter key by key, and both models
    read from it agree within 1e-5."""
    sd = dinov2.synthetic_hf_dinov2_state_dict("tiny-test", seed=5)
    jp = jdinov2.from_hf_dinov2(sd)
    got, ref = dinov2.from_hf_dinov2(sd), dinov2_state_dict(jp)
    assert set(got) == set(ref)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    model = dinov2.build_dinov2("tiny-test", device="cpu")
    model.load_state_dict(got)
    px = np.random.RandomState(6).randn(2, 28, 42, 3).astype(np.float32)
    rc, rp = jdinov2.DinoV2ViT(**TINY).apply({"params": jp},
                                             jnp.asarray(px))
    with torch.no_grad():
        gc, gp = model(torch.as_tensor(px))
    _close(gc.numpy(), rc)
    _close(gp.numpy(), rp)


def test_build_checks_the_name():
    with pytest.raises(ValueError, match="unknown DINOv2"):
        dinov2.build_dinov2("dinov3", device="cpu")


class _Spy:
    """Stands in for the three attention entry points and records which
    one ``attend`` called."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("oneshot_attention_packed", "oneshot_attention",
                     "flash_attention_padded"):
            monkeypatch.setattr(att, name, self._entry(name))

    def _entry(self, name):
        def run(q, *args):
            self.calls.append((name, tuple(q.shape)))
            return torch.zeros_like(q)
        return run


@pytest.mark.parametrize("t,heads,dtype,packed_env,want", [
    (769, 16, torch.bfloat16, None, "oneshot_attention_packed"),
    (769, 16, torch.bfloat16, "0", "oneshot_attention"),
    (1370, 16, torch.bfloat16, None, "oneshot_attention"),
    (3073, 16, torch.bfloat16, None, "flash_attention_padded"),
    (3026, 6, torch.float32, None, "flash_attention_padded"),
    (16130, 6, torch.float32, None, "flash_attention_padded"),
    (197, 6, torch.float32, None, "oneshot_attention"),
    (197, 12, torch.float32, None, "oneshot_attention_packed")])
def test_attend_routes_as_jax(monkeypatch, t, heads, dtype, packed_env,
                              want):
    """``ops.attention.attend`` picks the entry point that the JAX
    teachers' predicates name: DINOv2-L/14 in bf16 at 336x448 (T = 769),
    518x518 (1370) and 672x896 (3073); DINO v1 S/8 at stride 4 in float32
    at 224x224 (3026) and 512x512 (16130), and at stride 16 (197) with 6
    heads (no packed group) and 12 (B/16)."""
    if packed_env is None:
        monkeypatch.delenv("DROPCLIP_PACKED_ATTN", raising=False)
    else:
        monkeypatch.setenv("DROPCLIP_PACKED_ATTN", packed_env)
    spy = _Spy(monkeypatch)
    q = torch.zeros((1, t, heads * 64), dtype=dtype)
    out = att.attend(q, q, q, heads)
    assert out.shape == q.shape
    assert [c[0] for c in spy.calls] == [want]
    itemsize = q.element_size()
    if att.supports_packed(t, heads, 64, False, itemsize) and \
            packed_env != "0":
        assert want == "oneshot_attention_packed"
    elif att.supports(t, 64, False, itemsize):
        assert want == "oneshot_attention"


@pytest.mark.slow
def test_vitl14_two_layers_full_width_matches_jax():
    """dinov2_vitl14 at full width (1024, 16 heads of 64), cut to two
    blocks, on one 518x518 input (T = 1370, K4's route on the card):
    float32 cls and patch tokens within 1e-4 of max|ref|."""
    kw = dict(width=1024, layers=2, heads=16)
    jm = jdinov2.DinoV2ViT(**kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(7), jnp.zeros((1, 518, 518, 3)))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    model = dinov2.build_dinov2("dinov2_vitl14", device="cpu", layers=2)
    model.load_state_dict(dinov2_state_dict(params))
    px = np.random.RandomState(8).randn(1, 518, 518, 3).astype(np.float32)
    rc, rp = jax.jit(jm.apply)(v, jnp.asarray(px))
    with torch.no_grad():
        gc, gp = model(torch.as_tensor(px))
    _close(gc.numpy(), rc, rel=1e-4)
    _close(gp.numpy(), rp, rel=1e-4)
