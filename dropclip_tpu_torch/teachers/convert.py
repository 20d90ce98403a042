"""CLIP checkpoint files -> the port's CLIP state dicts.

Port of ``dropclip_tpu/teachers/convert.py``. Two public weight layouts:

- **OpenAI** (the JIT archives the reference downloads, reference
  models/features/clip/clip.py:98-203 and build_model model.py:469-506):
  fused ``attn.in_proj_weight`` per block, ``visual.transformer.resblocks.*``
  naming, fp16 tensors;
- **HuggingFace** ``CLIPModel`` state dicts: split q/k/v projections,
  ``vision_model.encoder.layers.*`` naming.

Both map straight to ``CLIP.state_dict()``'s keys (those
``convert.clip_state_dict`` gives for a flax tree) in float32: torch
``Linear`` weights stay (out, in), LayerNorm ``weight`` becomes ``scale``,
the (width, 3, p, p) patch conv becomes the (width, p*p*3) weight of the
linear layer over (kh, kw, c)-ordered patches. The ModifiedResNet (RN)
towers raise: the port's ``CLIP`` has no RN tower yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

_RN_TODO = ("the ModifiedResNet (RN) CLIP towers are not ported yet: they "
            "wait for their ROADMAP queue 1 item 6 entry, the ModifiedResNet "
            "(RN) towers")


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def _block(sd: Mapping[str, Any], src: str, dst: str, names: Dict[str, str],
           out: Dict[str, torch.Tensor]) -> None:
    """One residual block; ``names`` maps the port's sub-module names to
    the layout's."""
    for port, theirs in names.items():
        w, b = _t(sd[f"{src}.{theirs}.weight"]), _t(sd[f"{src}.{theirs}.bias"])
        leaf = "scale" if port.startswith("ln_") else "weight"
        out[f"{dst}.{port}.{leaf}"] = w
        out[f"{dst}.{port}.bias"] = b


def _openai_block(sd, src: str, dst: str, out) -> None:
    w = _t(sd[f"{src}.attn.in_proj_weight"])  # (3d, d): q, k, v rows
    b = _t(sd[f"{src}.attn.in_proj_bias"])
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        d = w.shape[1]
        out[f"{dst}.attn.{name}.weight"] = w[i * d:(i + 1) * d].contiguous()
        out[f"{dst}.attn.{name}.bias"] = b[i * d:(i + 1) * d].contiguous()
    _block(sd, src, dst, {"ln_1": "ln_1", "ln_2": "ln_2",
                          "attn.out_proj": "attn.out_proj",
                          "c_fc": "mlp.c_fc", "c_proj": "mlp.c_proj"}, out)


def _n_blocks(sd, prefix: str, pos: int) -> int:
    return max(int(k.split(".")[pos]) for k in sd if k.startswith(prefix)) + 1


def _patch_weight(w) -> torch.Tensor:
    """(width, 3, p, p) conv kernel -> (width, p*p*3) over (kh, kw, c)."""
    w = _t(w)
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()


def from_openai_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP state dict -> ``CLIP.state_dict()`` (ViT towers)."""
    if "visual.attnpool.positional_embedding" in sd:
        raise NotImplementedError(_RN_TODO)
    out = {
        "visual.conv1.weight": _patch_weight(sd["visual.conv1.weight"]),
        "visual.class_embedding": _t(sd["visual.class_embedding"]),
        "visual.positional_embedding": _t(sd["visual.positional_embedding"]),
        "visual.ln_pre.scale": _t(sd["visual.ln_pre.weight"]),
        "visual.ln_pre.bias": _t(sd["visual.ln_pre.bias"]),
        "visual.ln_post.scale": _t(sd["visual.ln_post.weight"]),
        "visual.ln_post.bias": _t(sd["visual.ln_post.bias"]),
        "visual.proj": _t(sd["visual.proj"]),
        "text.token_embedding.weight": _t(sd["token_embedding.weight"]),
        "text.positional_embedding": _t(sd["positional_embedding"]),
        "text.ln_final.scale": _t(sd["ln_final.weight"]),
        "text.ln_final.bias": _t(sd["ln_final.bias"]),
        "text.text_projection": _t(sd["text_projection"]),
        "logit_scale": _t(sd["logit_scale"]).reshape(()),
    }
    for i in range(_n_blocks(sd, "visual.transformer.resblocks.", 3)):
        _openai_block(sd, f"visual.transformer.resblocks.{i}",
                      f"visual.blocks.{i}", out)
    for i in range(_n_blocks(sd, "transformer.resblocks.", 2)):
        _openai_block(sd, f"transformer.resblocks.{i}", f"text.blocks.{i}",
                      out)
    return out


_HF_BLOCK = {"ln_1": "layer_norm1", "ln_2": "layer_norm2",
             "attn.q_proj": "self_attn.q_proj",
             "attn.k_proj": "self_attn.k_proj",
             "attn.v_proj": "self_attn.v_proj",
             "attn.out_proj": "self_attn.out_proj",
             "c_fc": "mlp.fc1", "c_proj": "mlp.fc2"}


def from_hf_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """HuggingFace ``CLIPModel.state_dict()`` -> ``CLIP.state_dict()``."""
    v, t = "vision_model.", "text_model."
    out = {
        "visual.conv1.weight": _patch_weight(
            sd[v + "embeddings.patch_embedding.weight"]),
        "visual.class_embedding": _t(
            sd[v + "embeddings.class_embedding"]).reshape(-1),
        "visual.positional_embedding": _t(
            sd[v + "embeddings.position_embedding.weight"]),
        # (sic) "pre_layrnorm" is HF's spelling
        "visual.ln_pre.scale": _t(sd[v + "pre_layrnorm.weight"]),
        "visual.ln_pre.bias": _t(sd[v + "pre_layrnorm.bias"]),
        "visual.ln_post.scale": _t(sd[v + "post_layernorm.weight"]),
        "visual.ln_post.bias": _t(sd[v + "post_layernorm.bias"]),
        "visual.proj": _t(sd["visual_projection.weight"]).T.contiguous(),
        "text.token_embedding.weight": _t(
            sd[t + "embeddings.token_embedding.weight"]),
        "text.positional_embedding": _t(
            sd[t + "embeddings.position_embedding.weight"]),
        "text.ln_final.scale": _t(sd[t + "final_layer_norm.weight"]),
        "text.ln_final.bias": _t(sd[t + "final_layer_norm.bias"]),
        "text.text_projection": _t(
            sd["text_projection.weight"]).T.contiguous(),
        "logit_scale": _t(sd["logit_scale"]).reshape(()),
    }
    for i in range(_n_blocks(sd, v + "encoder.layers.", 3)):
        _block(sd, f"{v}encoder.layers.{i}", f"visual.blocks.{i}", _HF_BLOCK,
               out)
    for i in range(_n_blocks(sd, t + "encoder.layers.", 3)):
        _block(sd, f"{t}encoder.layers.{i}", f"text.blocks.{i}", _HF_BLOCK,
               out)
    return out


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file (.pt/.pth, either layout) ->
    ``CLIP.state_dict()``. ``torch.load`` hands an OpenAI JIT archive to
    ``torch.jit.load``, whose ``state_dict()`` is the plain layout."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    if any(k.startswith("vision_model.") for k in sd):
        return from_hf_state_dict(sd)
    return from_openai_state_dict(sd)


def _random(checkpoint: Optional[str]) -> bool:
    """A falsy or literal "random" checkpoint draws weights (the
    framework-wide smoke-mode convention)."""
    return not checkpoint or checkpoint == "random"


def build_clip_from(name: str, checkpoint: Optional[str],
                    dtype: torch.dtype = torch.bfloat16, device=None,
                    seed: int = 0, context: str = "teacher"):
    """CLIP config ``name`` on ``device`` with linear layers in ``dtype``:
    weights from ``checkpoint``, or drawn from ``seed`` with a loud warning
    when it is falsy or "random" (``build_clip_variables`` in the JAX
    package). Loading copies float32 into the cast layers, the rounding
    ``cast_`` gives."""
    from .clip import CLIP, CLIP_CONFIGS, build_clip
    from ..core.device import resolve_device

    if _random(checkpoint):
        print(f"WARNING: no CLIP checkpoint for {context}; using RANDOM "
              f"teacher weights from seed {seed} (smoke mode)")
        return build_clip(name, dtype=dtype, device=device,
                          generator=torch.Generator().manual_seed(seed))
    device = resolve_device(device)
    if isinstance(CLIP_CONFIGS[name]["vision_layers"], (tuple, list)):
        raise NotImplementedError(_RN_TODO)
    model = CLIP(**CLIP_CONFIGS[name], dtype=dtype).cast_()
    model.load_state_dict(load_params(checkpoint))
    return model.to(device).eval()


def build_clip_text_from(name: str, checkpoint: Optional[str],
                         dtype: torch.dtype = torch.bfloat16, seed: int = 0):
    """The text tower of CLIP config ``name`` on the CPU (the caller moves
    it): weights from ``checkpoint``'s ``text.*`` entries, or drawn from
    ``seed`` as ``build_clip_from`` does."""
    from .clip import build_clip_text

    model = build_clip_text(name, dtype=dtype,
                            generator=torch.Generator().manual_seed(seed))
    if _random(checkpoint):
        print("WARNING: no CLIP checkpoint for the text encoder; using "
              f"RANDOM text-tower weights from seed {seed} (smoke mode)")
        return model
    model.load_state_dict({k[len("text."):]: v for k, v in
                           load_params(checkpoint).items()
                           if k.startswith("text.")})
    return model


def synthetic_openai_state_dict(name: str, seed: int = 0,
                                dtype: torch.dtype = torch.float16
                                ) -> Dict[str, torch.Tensor]:
    """An OpenAI-layout state dict of the ViT config ``name`` with weights
    drawn by numpy from ``seed`` (dense weights at std fan_in^-0.5, unit
    LayerNorms with 10% noise), stored in ``dtype`` as the OpenAI files
    are: a checkpoint file for tests and smoke runs that has to exist
    without a download."""
    import numpy as np

    from .clip import CLIP_CONFIGS

    c = CLIP_CONFIGS[name]
    if isinstance(c["vision_layers"], (tuple, list)):
        raise NotImplementedError(_RN_TODO)
    rng = np.random.default_rng(seed)

    def draw(*shape, std=1.0, mean=0.0):
        x = rng.standard_normal(shape, dtype=np.float32) * std + mean
        return torch.from_numpy(x).to(dtype)

    sd: Dict[str, torch.Tensor] = {}

    def blocks(prefix: str, width: int, layers: int) -> None:
        for i in range(layers):
            p = f"{prefix}.{i}"
            for ln in ("ln_1", "ln_2"):
                sd[f"{p}.{ln}.weight"] = draw(width, std=0.1, mean=1.0)
                sd[f"{p}.{ln}.bias"] = draw(width, std=0.1)
            sd[f"{p}.attn.in_proj_weight"] = draw(3 * width, width,
                                                  std=width ** -0.5)
            sd[f"{p}.attn.in_proj_bias"] = draw(3 * width, std=0.02)
            for lin, (o, n) in (("attn.out_proj", (width, width)),
                                ("mlp.c_fc", (4 * width, width)),
                                ("mlp.c_proj", (width, 4 * width))):
                sd[f"{p}.{lin}.weight"] = draw(o, n, std=n ** -0.5)
                sd[f"{p}.{lin}.bias"] = draw(o, std=0.02)

    vw, p, grid = c["vision_width"], c["vision_patch_size"], \
        c["image_resolution"] // c["vision_patch_size"]
    sd["visual.conv1.weight"] = draw(vw, 3, p, p, std=(3 * p * p) ** -0.5)
    sd["visual.class_embedding"] = draw(vw, std=vw ** -0.5)
    sd["visual.positional_embedding"] = draw(grid * grid + 1, vw,
                                             std=vw ** -0.5)
    blocks("visual.transformer.resblocks", vw, c["vision_layers"])
    tw = c["transformer_width"]
    sd["token_embedding.weight"] = draw(c["vocab_size"], tw, std=0.02)
    sd["positional_embedding"] = draw(c["context_length"], tw, std=0.01)
    blocks("transformer.resblocks", tw, c["transformer_layers"])
    for ln, w in (("visual.ln_pre", vw), ("visual.ln_post", vw),
                  ("ln_final", tw)):
        sd[f"{ln}.weight"] = draw(w, std=0.1, mean=1.0)
        sd[f"{ln}.bias"] = draw(w, std=0.1)
    sd["visual.proj"] = draw(vw, c["embed_dim"], std=vw ** -0.5)
    sd["text_projection"] = draw(tw, c["embed_dim"], std=tw ** -0.5)
    sd["logit_scale"] = torch.tensor(4.6052, dtype=dtype)
    return sd
