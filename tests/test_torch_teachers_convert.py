"""CLIP checkpoint files: dropclip_tpu_torch.teachers.convert against
dropclip_tpu.teachers.convert on a tiny-test state dict synthesised from a
seed with numpy (OpenAI layout, its HuggingFace twin, a TorchScript
archive), both packages' towers from one file, and the readers that take
a checkpoint path (make_clip_sim, build_extractor)."""

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
    sd = dict(openai_sd)
    sd["visual.attnpool.positional_embedding"] = torch.zeros(5, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP.*RN"):
        convert.from_openai_state_dict(sd)
    path = str(tmp_path / "rn.pt")
    torch.save(sd, path)
    with pytest.raises(NotImplementedError, match="ROADMAP.*RN"):
        convert.build_clip_from("tiny-test-rn", path, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.*RN"):
        convert.synthetic_openai_state_dict("RN50")


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
