"""CLIP's ViT vision tower (OpenAI's ``CLIP.encode_image``) in plain
PyTorch over a dict of weights.

The tower: a patch convolution (kernel and stride the patch size, no
bias), the class token, the positional embedding, ``ln_pre``, ``layers``
pre-norm residual blocks of multi-head attention and a ``4 * width``
quick-GELU MLP, ``ln_post`` of the class token and its projection to
the embedding. The positional embedding is trained on a square grid; a
wider input takes it resized bicubically with DINO's +0.1 on the scale
(``F.interpolate`` with ``scale_factor=((gh + 0.1) / g, (gw + 0.1) /
g)``), as CLIP's patch-feature users resize it for a 336x448 input (24
by 32 patches at 14 pixels).

Computed as the configuration states it, in bf16: LayerNorms in float32
rounded to bf16, linears (the patch convolution and the projection
among them) in bf16, attention logits and softmax in float32, the
probabilities rounded to bf16 before the product with the values.
``precision`` "fp8" rounds every linear's input and weight to float8
e4m3 (each tensor scaled to its largest value) before the product: the
control. Weight names follow the program's tower (``visual.`` then
``class_embedding``, ``positional_embedding``, ``conv1.weight`` as a
(width, kh * kw * 3) matrix in (kh, kw, channel) order,
``ln_pre.{scale,bias}``, ``blocks.<i>.{ln_1,ln_2}.{scale,bias}``,
``blocks.<i>.attn.{q,k,v,out}_proj.{weight,bias}``,
``blocks.<i>.{c_fc,c_proj}.{weight,bias}``, ``ln_post.{scale,bias}``,
``proj``)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .clip_text import _fp8

PREFIX = "visual."


def weight_shapes(width: int, layers: int, patch: int, resolution: int,
                  embed_dim: int) -> Dict[str, tuple]:
    grid = resolution // patch
    p = PREFIX
    shapes = {f"{p}class_embedding": (width,),
              f"{p}positional_embedding": (grid * grid + 1, width),
              f"{p}conv1.weight": (width, patch * patch * 3),
              f"{p}ln_pre.scale": (width,), f"{p}ln_pre.bias": (width,)}
    for i in range(layers):
        b = f"{p}blocks.{i}"
        for ln in ("ln_1", "ln_2"):
            shapes[f"{b}.{ln}.scale"] = (width,)
            shapes[f"{b}.{ln}.bias"] = (width,)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{b}.attn.{proj}.weight"] = (width, width)
            shapes[f"{b}.attn.{proj}.bias"] = (width,)
        shapes[f"{b}.c_fc.weight"] = (4 * width, width)
        shapes[f"{b}.c_fc.bias"] = (4 * width,)
        shapes[f"{b}.c_proj.weight"] = (width, 4 * width)
        shapes[f"{b}.c_proj.bias"] = (width,)
    shapes[f"{p}ln_post.scale"] = (width,)
    shapes[f"{p}ln_post.bias"] = (width,)
    shapes[f"{p}proj"] = (width, embed_dim)
    return shapes


def init(name: str, shape: tuple) -> tuple:
    """CLIP's initializer scales: the class token, positional embedding
    and projection at width ** -0.5, lecun normal linears, zero biases,
    unit LayerNorms."""
    if name.endswith(("class_embedding", "positional_embedding", "proj")):
        width = shape[0] if name.endswith(("class_embedding", "proj")) \
            else shape[1]
        return width ** -0.5, 0.0
    if name.endswith(".weight"):
        return shape[1] ** -0.5, 0.0
    if name.endswith(".scale"):
        return 0.0, 1.0
    return 0.0, 0.0


def is_linear(name: str) -> bool:
    """A weight or bias of a linear layer (stored in bf16): the patch
    convolution and the blocks' linears."""
    return name.endswith("conv1.weight") or any(
        f".{n}." in name for n in ("q_proj", "k_proj", "v_proj",
                                   "out_proj", "c_fc", "c_proj"))


def positional(w: Dict[str, torch.Tensor], gh: int, gw: int
               ) -> torch.Tensor:
    """The positional embedding for a gh x gw grid: the trained square
    grid resized bicubically (DINO's +0.1 on the scale), float32."""
    pe = w[f"{PREFIX}positional_embedding"].float()
    g = int(round((pe.shape[0] - 1) ** 0.5))
    if (gh, gw) == (g, g):
        return pe
    grid = pe[1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    out = F.interpolate(grid, scale_factor=((gh + 0.1) / g, (gw + 0.1) / g),
                        mode="bicubic", align_corners=False,
                        recompute_scale_factor=False)
    assert out.shape[-2:] == (gh, gw), out.shape
    return torch.cat([pe[:1], out[0].permute(1, 2, 0).reshape(gh * gw, -1)])


def encode(w: Dict[str, torch.Tensor], pixels: torch.Tensor, heads: int,
           patch: int, precision: str = "bf16") -> torch.Tensor:
    """(B, H, W, 3) CLIP-normalised float pixels -> (B, embed_dim)
    float32 class-token features."""
    dt = torch.bfloat16
    q8 = _fp8 if precision == "fp8" else (lambda t: t)
    p = PREFIX

    def linear(x, name):
        return F.linear(q8(x), q8(w[f"{name}.weight"].to(dt)),
                        w[f"{name}.bias"].to(dt))

    def norm(x, name):
        return F.layer_norm(x.float(), x.shape[-1:], w[f"{name}.scale"],
                            w[f"{name}.bias"], 1e-5).to(dt)

    b, h, wd, _ = pixels.shape
    width = w[f"{p}conv1.weight"].shape[0]
    kernel = w[f"{p}conv1.weight"].to(dt).reshape(
        width, patch, patch, 3).permute(0, 3, 1, 2)
    x = F.conv2d(q8(pixels.to(dt).permute(0, 3, 1, 2)), q8(kernel),
                 stride=patch)                      # (B, width, gh, gw)
    gh, gw = x.shape[-2:]
    x = x.flatten(2).transpose(1, 2)
    cls = w[f"{p}class_embedding"].to(dt).expand(b, 1, width)
    x = torch.cat([cls, x], dim=1) + positional(w, gh, gw).to(dt)
    x = norm(x, f"{p}ln_pre")
    t = x.shape[1]
    n_layers = len({k.split(".")[2] for k in w if k.startswith(
        f"{p}blocks.")})
    for i in range(n_layers):
        blk = f"{p}blocks.{i}"
        hx = norm(x, f"{blk}.ln_1")
        split = lambda y: y.reshape(b, t, heads, -1).transpose(1, 2)  # noqa
        q, k, v = (split(linear(hx, f"{blk}.attn.{n}_proj"))
                   for n in ("q", "k", "v"))
        logits = (q.float() @ k.float().transpose(-1, -2)) \
            * q.shape[-1] ** -0.5
        a = torch.softmax(logits, -1).to(dt) @ v
        x = x + linear(a.transpose(1, 2).reshape(b, t, -1),
                       f"{blk}.attn.out_proj")
        hx = linear(norm(x, f"{blk}.ln_2"), f"{blk}.c_fc")
        x = x + linear(hx * torch.sigmoid(1.702 * hx), f"{blk}.c_proj")
    pooled = norm(x[:, 0], f"{p}ln_post")
    return (q8(pooled) @ q8(w[f"{p}proj"].to(dt))).float()
