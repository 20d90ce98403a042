"""CLIP checkpoint files: dropclip_tpu_torch.teachers.convert against
dropclip_tpu.teachers.convert on a tiny-test state dict synthesised from a
seed with numpy (OpenAI layout, its HuggingFace twin, a TorchScript
archive; the RN tower's OpenAI layout), both packages' towers from one
file, and the readers that take a checkpoint path (make_clip_sim,
build_extractor). The DINO teachers' converters (HuggingFace
``Dinov2Model`` and facebookresearch/dino layouts) against the JAX ones."""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch import nn

from dropclip_tpu.teachers import convert as jconvert
from dropclip_tpu.teachers.clip import build_clip as jbuild_clip
from dropclip_tpu_torch.convert import clip_state_dict
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.pipeline import make_clip_sim
from dropclip_tpu_torch.teachers import convert
from dropclip_tpu_torch.teachers.tokenizer import tokenize
from dropclip_tpu_torch.tools.preprocess_data import build_extractor

PROMPTS = ["a red mug", "the green bowl", "a photo of a spoon", "box"]


def openai_to_hf(sd):
    """The HuggingFace ``CLIPModel`` layout of an OpenAI state dict."""
    out = {}

    def blocks(src, dst):
        n = 1 + max(int(k[len(src) + 1:].split(".")[0]) for k in sd
                    if k.startswith(src + "."))
        for i in range(n):
            s, d = f"{src}.{i}", f"{dst}.{i}"
            for a, b in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                         ("attn.out_proj", "self_attn.out_proj"),
                         ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
                for leaf in ("weight", "bias"):
                    out[f"{d}.{b}.{leaf}"] = sd[f"{s}.{a}.{leaf}"]
            for leaf in ("weight", "bias"):
                for j, q in enumerate(torch.chunk(
                        sd[f"{s}.attn.in_proj_{leaf}"], 3, dim=0)):
                    out[f"{d}.self_attn.{'qkv'[j]}_proj.{leaf}"] = q

    blocks("visual.transformer.resblocks", "vision_model.encoder.layers")
    blocks("transformer.resblocks", "text_model.encoder.layers")
    v, t = "vision_model.", "text_model."
    out[v + "embeddings.patch_embedding.weight"] = sd["visual.conv1.weight"]
    out[v + "embeddings.class_embedding"] = sd["visual.class_embedding"]
    out[v + "embeddings.position_embedding.weight"] = \
        sd["visual.positional_embedding"]
    for a, b in (("visual.ln_pre", "pre_layrnorm"),
                 ("visual.ln_post", "post_layernorm")):
        out[f"{v}{b}.weight"] = sd[f"{a}.weight"]
        out[f"{v}{b}.bias"] = sd[f"{a}.bias"]
    out["visual_projection.weight"] = sd["visual.proj"].t()
    out[t + "embeddings.token_embedding.weight"] = sd["token_embedding.weight"]
    out[t + "embeddings.position_embedding.weight"] = \
        sd["positional_embedding"]
    out[t + "final_layer_norm.weight"] = sd["ln_final.weight"]
    out[t + "final_layer_norm.bias"] = sd["ln_final.bias"]
    out["text_projection.weight"] = sd["text_projection"].t()
    out["logit_scale"] = sd["logit_scale"]
    return out


def jit_archive(sd, path):
    """A TorchScript archive whose ``state_dict()`` is ``sd`` (the form of
    the OpenAI downloads)."""
    root = nn.Module()
    for key, val in sd.items():
        *path_parts, leaf = key.split(".")
        mod = root
        for part in path_parts:
            if not hasattr(mod, part):
                mod.add_module(part, nn.Module())
            mod = getattr(mod, part)
        mod.register_buffer(leaf, val)
    torch.jit.script(root).save(path)


@pytest.fixture(scope="module")
def openai_sd():
    return convert.synthetic_openai_state_dict("tiny-test", seed=3)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, openai_sd):
    path = str(tmp_path_factory.mktemp("clip") / "tiny.pt")
    torch.save(openai_sd, path)
    return path


@pytest.mark.parametrize("layout", ["openai", "hf"])
def test_converters_equal_jax_key_by_key(openai_sd, layout):
    """The port's converter equals convert.clip_state_dict of the JAX
    converter's flax tree: the same keys, every tensor exactly equal."""
    sd = openai_sd if layout == "openai" else openai_to_hf(openai_sd)
    jfn, fn = {"openai": (jconvert.from_openai_state_dict,
                          convert.from_openai_state_dict),
               "hf": (jconvert.from_hf_state_dict,
                      convert.from_hf_state_dict)}[layout]
    ref = clip_state_dict(jax.tree_util.tree_map(np.asarray, jfn(sd)))
    got = fn(sd)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], ref[k]), k


def test_load_params_reads_every_file_form(tmp_path, openai_sd):
    """A plain state dict in either layout and a TorchScript archive give
    the same state dict; it loads into the port's CLIP."""
    ref = convert.from_openai_state_dict(openai_sd)
    paths = {"openai": str(tmp_path / "a.pt"), "hf": str(tmp_path / "b.pt"),
             "jit": str(tmp_path / "c.pt")}
    torch.save(openai_sd, paths["openai"])
    torch.save(openai_to_hf(openai_sd), paths["hf"])
    jit_archive(openai_sd, paths["jit"])
    for form, path in paths.items():
        got = convert.load_params(path)
        assert set(got) == set(ref), form
        assert all(torch.equal(got[k], ref[k]) for k in ref), form
    model = convert.build_clip_from("tiny-test", paths["jit"],
                                    dtype=torch.float32, device="cpu")
    assert all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())


def test_towers_from_one_file_match_jax(ckpt):
    """encode_text and encode_image (class token and MaskCLIP patches) of
    both packages' float32 CLIP read from the same file: within 1e-5 of
    max|ref|."""
    jclip = jbuild_clip("tiny-test", use_flash=False)
    jvars = {"params": jconvert.load_params(ckpt)}
    model = convert.build_clip_from("tiny-test", ckpt, dtype=torch.float32,
                                    device="cpu")
    toks = tokenize(PROMPTS)
    px = np.random.default_rng(0).standard_normal(
        (2, 48, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = {"text": model.encode_text(torch.as_tensor(toks)),
               "image": model.encode_image(torch.as_tensor(px)),
               "patch": model.get_patch_encodings(torch.as_tensor(px))}
    ref = {"text": jclip.apply(jvars, jnp.asarray(toks),
                               method="encode_text"),
           "image": jclip.apply(jvars, jnp.asarray(px),
                                method="encode_image"),
           "patch": jclip.apply(jvars, jnp.asarray(px),
                                method="get_patch_encodings")}
    for k in ref:
        r = np.asarray(ref[k]).reshape(got[k].shape)
        err = np.abs(got[k].numpy() - r).max()
        assert err <= 1e-5 * np.abs(r).max(), (k, err)


def test_rn_layouts_raise(tmp_path, openai_sd):
    """A file of one tower family read into a config of the other raises
    (the RN entries are read since the RN towers were ported)."""
    rn = convert.synthetic_openai_state_dict("tiny-test-rn", seed=4)
    paths = {"vit": str(tmp_path / "vit.pt"), "rn": str(tmp_path / "rn.pt")}
    torch.save(openai_sd, paths["vit"])
    torch.save(rn, paths["rn"])
    for name, path in (("tiny-test", paths["rn"]),
                       ("tiny-test-rn", paths["vit"])):
        with pytest.raises(RuntimeError, match="Missing key"):
            convert.build_clip_from(name, path, device="cpu")


@pytest.fixture(scope="module")
def rn_sd():
    return convert.synthetic_openai_state_dict("tiny-test-rn", seed=5)


def test_rn_converter_equals_jax_key_by_key(rn_sd):
    """OpenAI RN layout: the port's converter equals clip_state_dict of
    the JAX converter's tree (BatchNorm running stats, downsample branch,
    attention pool), every tensor exactly; it fills every parameter of
    the port's RN CLIP."""
    ref = clip_state_dict(jax.tree_util.tree_map(
        np.asarray, jconvert.from_openai_state_dict(rn_sd)))
    got = convert.from_openai_state_dict(rn_sd)
    assert set(got) == set(ref)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    from dropclip_tpu_torch.teachers.clip import CLIP, CLIP_CONFIGS

    assert set(got) == set(CLIP(**CLIP_CONFIGS["tiny-test-rn"]).state_dict())


@pytest.mark.parametrize("name", ["RN50", "RN101", "RN50x4"])
def test_rn_files_of_every_published_layout(name):
    """synthetic_openai_state_dict draws each published RN layout: the
    JAX converter reads it and the port's CLIP of that name takes it."""
    from dropclip_tpu_torch.teachers.clip import CLIP, CLIP_CONFIGS

    sd = convert.synthetic_openai_state_dict(name, seed=0,
                                             dtype=torch.bfloat16)
    jtree = jconvert.from_openai_state_dict(sd)
    got = convert.from_openai_state_dict(sd)
    assert len(got) == len(clip_state_dict(jtree))
    model = CLIP(**CLIP_CONFIGS[name])
    model.load_state_dict(got)
    assert model.visual.attnpool.positional_embedding.shape == (
        (CLIP_CONFIGS[name]["image_resolution"] // 32) ** 2 + 1,
        CLIP_CONFIGS[name]["vision_width"] * 32)


def test_rn_towers_from_one_file_match_jax(tmp_path, rn_sd):
    """build_clip_from and build_clip_text_from on an RN file against the
    JAX CLIP from load_params: encode_image, non-square patch features and
    encode_text within 1e-5 of max|ref| in float32."""
    path = str(tmp_path / "rn.pt")
    torch.save(rn_sd, path)
    jclip = jbuild_clip("tiny-test-rn", use_flash=False)
    jvars = {"params": jconvert.load_params(path)}
    model = convert.build_clip_from("tiny-test-rn", path,
                                    dtype=torch.float32, device="cpu")
    text = convert.build_clip_text_from("tiny-test-rn", path,
                                        dtype=torch.float32)
    toks = tokenize(PROMPTS)
    rs = np.random.RandomState(0)
    px = rs.randn(2, 64, 64, 3).astype(np.float32)
    wide = rs.randn(2, 96, 160, 3).astype(np.float32)
    with torch.no_grad():
        got = {"text": model.encode_text(torch.as_tensor(toks)),
               "text_tower": text(torch.as_tensor(toks)),
               "image": model.encode_image(torch.as_tensor(px)),
               "patch": model.get_patch_encodings(torch.as_tensor(wide))}
    ref = {"text": jclip.apply(jvars, jnp.asarray(toks),
                               method="encode_text"),
           "image": jclip.apply(jvars, jnp.asarray(px),
                                method="encode_image"),
           "patch": jclip.apply(jvars, jnp.asarray(wide),
                                method="get_patch_encodings")}
    ref["text_tower"] = ref["text"]
    for k in got:
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape, k
        err = np.abs(got[k].numpy() - r).max()
        assert err <= 1e-5 * np.abs(r).max(), (k, err)


@pytest.fixture(scope="module")
def hf_dinov2():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    out = {}
    for ffn in ("mlp", "swiglu"):
        cfg = transformers.Dinov2Config(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, image_size=28, patch_size=14,
            layer_norm_eps=1e-6, use_swiglu_ffn=ffn == "swiglu")
        m = transformers.Dinov2Model(cfg).eval()
        with torch.no_grad():
            for layer in m.encoder.layer:
                layer.layer_scale1.lambda1.mul_(0.7)
                layer.layer_scale2.lambda1.mul_(1.3)
        out[ffn] = m
    return out


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_dinov2_converter_equals_jax_key_by_key(hf_dinov2, ffn):
    """A ``transformers.Dinov2Model`` built from a tiny config: the port's
    from_hf_dinov2 equals dinov2_state_dict of the JAX converter's tree
    key by key, exactly; the port's model read from it gives HF's
    last_hidden_state within 1e-4 (HF's own attention and GELU)."""
    from dropclip_tpu.teachers.dinov2 import from_hf_dinov2 as jfrom
    from dropclip_tpu_torch.convert import dinov2_state_dict
    from dropclip_tpu_torch.teachers import dinov2

    hf = hf_dinov2[ffn]
    sd = hf.state_dict()
    ref = dinov2_state_dict(jax.tree_util.tree_map(np.asarray, jfrom(sd)))
    got = dinov2.from_hf_dinov2(sd)
    assert set(got) == set(ref)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    model = dinov2.build_dinov2("tiny-test", device="cpu", ffn=ffn)
    model.load_state_dict(got)
    px = np.random.RandomState(1).randn(2, 28, 28, 3).astype(np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.as_tensor(
            px.transpose(0, 3, 1, 2))).last_hidden_state
        cls, patch = model(torch.as_tensor(px))
    assert (cls - want[:, 0]).abs().max() < 1e-4
    assert (patch.reshape(2, 4, 64) - want[:, 1:]).abs().max() < 1e-4


def test_dino_v1_converter_equals_jax_key_by_key():
    """A facebookresearch/dino-layout state dict drawn from a seed: the
    port's from_dino_v1 equals dino_v1_state_dict of the JAX converter's
    tree key by key, and fills every parameter of the port's model."""
    from dropclip_tpu.teachers import dino_v1 as jdino
    from dropclip_tpu_torch.convert import dino_v1_state_dict
    from dropclip_tpu_torch.teachers import dino_v1

    sd = dino_v1.synthetic_dino_v1_state_dict("tiny-test-deep", seed=3)
    ref = dino_v1_state_dict(jax.tree_util.tree_map(
        np.asarray, jdino.from_dino_v1(sd)))
    got = dino_v1.from_dino_v1(sd)
    assert set(got) == set(ref)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert set(got) == set(dino_v1.build_dino_v1(
        "tiny-test-deep", 2, device="cpu").state_dict())


def test_readers_take_a_checkpoint_path(ckpt, capsys):
    """make_clip_sim loads the file's text tower in bf16 (within the bf16
    limit of the JAX package's make_clip_sim on the same file: cosine >=
    0.999 per prompt) and keeps the config's method and threshold;
    build_extractor loads the whole CLIP; "random" draws from the seed
    with the loud warning."""
    from dropclip_tpu.core.config import CfgNode as JCfg
    from dropclip_tpu.tools.train_distil import make_clip_sim as jmake

    kw = dict(clip_model="tiny-test", clip_checkpoint=ckpt,
              sim_method="argmax", sim_norm_thresh=0.6)
    sim = make_clip_sim(CfgNode(dict(kw)), device="cpu")
    assert (sim.method, sim.threshold) == ("argmax", 0.6)
    assert next(sim.model.parameters()).device.type == "cpu"
    assert sim.model.blocks[0].c_fc.weight.dtype == torch.bfloat16
    got = sim.encode_text(PROMPTS).numpy()
    ref = np.asarray(jmake(JCfg(dict(kw))).encode_text(PROMPTS),
                     np.float32)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1)
                                 * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.999, cos
    ex = build_extractor(SimpleNamespace(
        clip_model="tiny-test", clip_checkpoint=ckpt,
        visual_prompt="crop-mask", crop_num_levels=1,
        crop_expansion_ratio=0.15, batch_size=4), device="cpu")
    ref_sd = convert.load_params(ckpt)
    for k, v in ex.model.state_dict().items():
        assert torch.equal(v, ref_sd[k].to(v.dtype)), k
    capsys.readouterr()
    rnd = make_clip_sim(CfgNode(dict(kw, clip_checkpoint="random")),
                        device="cpu")
    assert "RANDOM" in capsys.readouterr().out
    assert not torch.equal(rnd.model.text_projection,
                           sim.model.text_projection)
