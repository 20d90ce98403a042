"""OpenCLIP ViT-H/14 in the port (``CLIP_CONFIGS["ViT-H-14"]``: 16
vision heads of 80, exact GELU in both towers) against the plain
reference of the benchmark (``benchmark/reference/openclip.py``) on the
CPU with seeded random weights, in float32: at a small ViT-H-shaped size
(two heads of 80, exact GELU, two blocks in each tower) the class-token
features, the MaskCLIP patch features and the text features; the same
weights with quick-GELU fail the same tolerance. The converter and the
ingest CLI's builder at the published widths, one block a tower."""

import argparse

import pytest
import torch

from benchmark.reference import openclip
from dropclip_tpu_torch.teachers import clip, convert

SMALL = dict(vision_width=160, vision_heads=2, vision_layers=2,
             image_resolution=28, transformer_width=64, transformer_heads=4,
             transformer_layers=2, embed_dim=32)


def _close(got, ref):
    return float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.fixture(scope="module")
def small():
    model = clip.build_clip("ViT-H-14", device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            **SMALL)
    w = {k: v.detach().clone() for k, v in model.state_dict().items()}
    px = torch.randn((3, 28, 42, 3), generator=torch.Generator()
                     .manual_seed(1))
    tok = torch.randint(1, 49000, (2, 77), generator=torch.Generator()
                        .manual_seed(2))
    tok[0, 6], tok[1, 11] = 49407, 49407
    return model, w, px, tok


def _reference(w, px, tok, act):
    text = {k[len("text."):]: v for k, v in w.items()
            if k.startswith("text.")}
    return dict(
        cls=openclip.encode_image(w, px, 2, 14, "float32", act),
        patch=openclip.encode_image(w, px, 2, 14, "float32", act,
                                    patches=True),
        text=openclip.encode_text(text, tok, 4, "float32", act))


@pytest.mark.parametrize("what", ["cls", "patch", "text"])
def test_small_vit_h_matches_the_reference(small, what):
    """Two heads of 80 (the plain version of K4 on the CPU), exact GELU:
    within 1e-4 of max|ref| in float32."""
    model, w, px, tok = small
    assert model.visual.blocks[0].attn.heads == 2
    assert model.visual.blocks[0].act is torch.nn.functional.gelu
    with torch.no_grad():
        got = dict(cls=model.encode_image(px),
                   patch=model.get_patch_encodings(px),
                   text=model.encode_text(tok))[what]
    ref = _reference(w, px, tok, "gelu")[what]
    assert got.shape == ref.shape
    assert _close(got, ref)


@pytest.mark.parametrize("what", ["cls", "patch", "text"])
def test_quick_gelu_fails_the_same_tolerance(small, what):
    """The reference with quick-GELU in GELU's place, on the same weights,
    is outside the tolerance the port meets."""
    model, w, px, tok = small
    with torch.no_grad():
        got = dict(cls=model.encode_image(px),
                   patch=model.get_patch_encodings(px),
                   text=model.encode_text(tok))[what]
    assert not _close(got, _reference(w, px, tok, "quick_gelu")[what])


def test_openai_configs_keep_quick_gelu():
    """Every OpenAI configuration keeps quick-GELU and heads of 64; only
    ViT-H-14 states its heads and takes GELU."""
    for name, c in clip.CLIP_CONFIGS.items():
        if name.startswith("ViT-H") or name == "tiny-test-h14":
            continue
        assert c["activation"] == "quick_gelu" and "vision_heads" not in c
    m = clip.CLIP(**{**clip.CLIP_CONFIGS["tiny-test"]})
    assert all(b.act is clip.quick_gelu for b in m.visual.blocks)
    assert all(b.act is clip.quick_gelu for b in m.text.blocks)


@pytest.fixture
def one_block(monkeypatch):
    """ViT-H-14 at its published widths with one block a tower."""
    monkeypatch.setitem(clip.CLIP_CONFIGS, "ViT-H-14", {
        **clip.CLIP_CONFIGS["ViT-H-14"], "vision_layers": 1,
        "transformer_layers": 1})


@pytest.mark.parametrize("wrapped", [False, True])
def test_build_clip_from_an_openclip_file(one_block, tmp_path, wrapped):
    """A synthetic state dict of ViT-H-14 in open_clip's layout (OpenAI's
    names; also under ``state_dict`` with the ``module.`` prefix):
    ``build_clip_from`` builds 16 vision heads of 80 and 16 text heads of
    64, exact GELU, and loads every leaf, as float32 rounded to bf16."""
    sd = convert.synthetic_openai_state_dict("ViT-H-14", seed=0,
                                             dtype=torch.float32)
    if wrapped:
        sd = {"state_dict": {f"module.{k}": v for k, v in sd.items()},
              "epoch": 32}
    path = str(tmp_path / "open_clip_pytorch_model.bin")
    torch.save(sd, path)
    model = convert.build_clip_from("ViT-H-14", path, device="cpu")
    blk = model.visual.blocks[0]
    assert blk.attn.heads == 16 and blk.attn.q_proj.weight.shape == (
        1280, 1280)
    assert model.text.blocks[0].attn.heads == 16
    assert blk.act is torch.nn.functional.gelu
    loaded = convert.load_params(path)
    assert set(loaded) == set(model.state_dict())
    plain = sd["state_dict"] if wrapped else sd
    src = plain["module.visual.proj" if wrapped else "visual.proj"]
    assert torch.equal(model.visual.proj, src.to(model.visual.proj.dtype))
    w = loaded["visual.blocks.0.c_fc.weight"].to(torch.bfloat16)
    assert torch.equal(blk.c_fc.weight, w)


def test_ingest_builder_takes_vit_h(one_block):
    """``preprocess_data --clip-model ViT-H-14`` builds the extractor at
    ViT-H/14's 224 x 294 crop canvas (16 x 21 patches), its 1024-d
    features; the OpenAI towers keep the recipe's 336 x 448."""
    from dropclip_tpu_torch.tools import preprocess_data

    args = argparse.Namespace(
        clip_model="ViT-H-14", clip_checkpoint=None, visual_prompt="crop-mask",
        crop_num_levels=1, crop_expansion_ratio=0.15, batch_size=32)
    ex = preprocess_data.build_extractor(args, device="cpu")
    assert ex.img_resize == (224, 294) and ex.patch_hw == (16, 21)
    assert ex.model.embed_dim == 1024
    args.clip_model = "tiny-test"
    assert preprocess_data.build_extractor(
        args, device="cpu").img_resize == (336, 448)
