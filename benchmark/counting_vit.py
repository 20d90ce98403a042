"""The work of the ingest teacher, counted from shapes, whatever
implements it.

A ViT forward over one image of ``tokens`` tokens (the class token and
the patches) at ``width``: the patch embedding, ``2 * patches * (p * p
* 3) * width``; per block the four attention projections and the
two-layer MLP at ``mlp_ratio * width``, ``2 * tokens * 12 * width**2``
at the usual ratio 4; the attention's two products, ``4 * tokens**2 *
width``; and the class token's projection, ``2 * width * embed``. The
text tower likewise over ``context`` tokens of each prompt, plus its
pooled token's projection. Bytes of one attention launch are its q, k,
v and output, each read or written once in the compute dtype."""

from __future__ import annotations

from typing import Dict


def vit_tokens(teacher: Dict) -> int:
    h, w = teacher["img_resize"]
    p = int(teacher["patch_size"])
    return 1 + (h // p) * (w // p)


def vit_flops(teacher: Dict, embed_dim: int) -> Dict[str, float]:
    """One image's operations: ``linear`` (patch embedding, block
    linears, projection) and ``attention`` (the two products)."""
    t = vit_tokens(teacher)
    p = int(teacher["patch_size"])
    w = int(teacher["vision_width"])
    layers = int(teacher["vision_layers"])
    linear = (2 * (t - 1) * p * p * 3 * w + layers * 2 * t * 12 * w * w
              + 2 * w * embed_dim)
    return {"linear": float(linear),
            "attention": float(layers * 4 * t * t * w)}


def text_flops(config: Dict, prompts: int) -> float:
    """``prompts`` text encodes at the configuration's context."""
    t, w = int(config["text_context"]), int(config["text_width"])
    layers = int(config["text_layers"])
    per = layers * (2 * t * 12 * w * w + 4 * t * t * w) \
        + 2 * w * int(config["embed_dim"])
    return float(prompts * per)


def attention_launch(teacher: Dict, rows: int, itemsize: int = 2
                     ) -> Dict[str, float]:
    """One packed attention launch over ``rows`` images: operations
    ``4 * rows * tokens**2 * width`` and bytes of q, k, v and output."""
    t = vit_tokens(teacher)
    w = int(teacher["vision_width"])
    return {"flops": float(4 * rows * t * t * w),
            "bytes": float(4 * rows * t * w * itemsize)}
