"""OpenCLIP's ViT-H/14 (``mlfoundations/open_clip``,
``src/open_clip/model_configs/ViT-H-14.json``: ``VisionTransformer`` and
``TextTransformer`` at ``embed_dim`` 1024; vision 1280 wide, 32 layers,
``head_width`` 80, so 16 heads, patch 14; text 1024 wide, 24 layers, 16
heads, context 77) and the MV-TOD ingest of one scene with it as the
teacher, in plain PyTorch over dicts of weights.

Both towers are pre-norm residual stacks as OpenAI's (``clip_vision.py``,
``clip_text.py``: the same weight names and initializer scales), with
the MLP's activation ``nn.GELU``, the exact (erf) form, where OpenAI has
quick-GELU, and the heads the configuration states. The vision tower
pools the class token after ``ln_post`` (open_clip's ``pool_type``
"tok": ``ln_post`` over every token then the first, the same numbers);
the text tower takes the end-of-text token (the largest id) after
``ln_final`` (``pool_type`` "argmax"), under a causal mask. The BPE
tokenizer and the mean/std normalisation are OpenAI's, as open_clip's.

``precision`` "float32" computes everything in float32 with TF32 off
(matmuls and the patch convolution); "bf16" as the configuration states
it, as ``clip_vision.py`` does: LayerNorms in float32 rounded to bf16,
linears in bf16, attention logits and softmax in float32, probabilities
rounded to bf16 before the product with the values, GELU on bf16 (which
PyTorch computes in float32 and rounds); "fp8" is bf16 with every
linear's input and weight rounded to float8 e4m3 (the control).

``scene`` is ``ingest.scene`` (its cloud, visibility, prompts, fusion)
with these towers: the same helpers of ``ingest.py``, the crops through
``encode_image`` and the queries through ``encode_text``.

Departures from open_clip: the positional embedding, trained on 16 x 16
patches, is resized for the 16 x 21 patches of the 224 x 294 crop canvas
bicubically with DINO's +0.1 on the scale (``clip_vision.positional``,
as the program and CLIP's patch-feature users do), where open_clip's
``resize_pos_embed`` resizes to the grid's size; bf16 as above (open_clip
runs its towers in float32 or under autocast). No dropout, no patch
dropout, no layer scale: ViT-H/14's configuration has none at inference.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import clip_text, clip_vision
from . import ingest as ref

PREFIX = clip_vision.PREFIX


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTS = {"gelu": F.gelu, "quick_gelu": quick_gelu}


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matmuls and convolutions inside, as it was after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _ops(w, precision: str):
    """The compute dtype, the fp8 rounding, and the linear and LayerNorm of
    ``precision``."""
    dt = torch.float32 if precision == "float32" else torch.bfloat16
    q8 = clip_text._fp8 if precision == "fp8" else (lambda t: t)

    def linear(x, name):
        return F.linear(q8(x), q8(w[f"{name}.weight"].to(dt)),
                        w[f"{name}.bias"].to(dt))

    def norm(x, name):
        return F.layer_norm(x.float(), x.shape[-1:], w[f"{name}.scale"],
                            w[f"{name}.bias"], 1e-5).to(dt)
    return dt, q8, linear, norm


def _block(x, blk: str, heads: int, linear, norm, act, causal=None):
    """One pre-norm residual block: attention (float32 logits and softmax,
    probabilities in the compute dtype), then the MLP with ``act``."""
    b, t, _ = x.shape
    hx = norm(x, f"{blk}.ln_1")
    split = lambda y: y.reshape(b, t, heads, -1).transpose(1, 2)  # noqa
    q, k, v = (split(linear(hx, f"{blk}.attn.{n}_proj"))
               for n in ("q", "k", "v"))
    logits = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal is not None:
        logits = logits.masked_fill(~causal, torch.finfo(torch.float32).min)
    a = torch.softmax(logits, -1).to(x.dtype) @ v
    x = x + linear(a.transpose(1, 2).reshape(b, t, -1),
                   f"{blk}.attn.out_proj")
    return x + linear(act(linear(norm(x, f"{blk}.ln_2"), f"{blk}.c_fc")),
                      f"{blk}.c_proj")


def encode_image(w: Dict[str, torch.Tensor], pixels: torch.Tensor,
                 heads: int, patch: int, precision: str = "bf16",
                 act: str = "gelu", patches: bool = False) -> torch.Tensor:
    """(B, H, W, 3) CLIP-normalised float pixels -> (B, embed_dim)
    float32 class-token features (``VisionTransformer.forward``), or with
    ``patches`` (B, gh * gw, embed_dim) MaskCLIP patch features: the last
    block's value path alone (``out_proj(v_proj(ln_1(x)))``, no residual,
    no MLP), then ``ln_post`` and the projection of every patch token."""
    dt, q8, linear, norm = _ops(w, precision)
    p = PREFIX
    b = pixels.shape[0]
    width = w[f"{p}conv1.weight"].shape[0]
    with no_tf32():
        kernel = w[f"{p}conv1.weight"].to(dt).reshape(
            width, patch, patch, 3).permute(0, 3, 1, 2)
        x = F.conv2d(q8(pixels.to(dt).permute(0, 3, 1, 2)), q8(kernel),
                     stride=patch)                  # (B, width, gh, gw)
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)
        cls = w[f"{p}class_embedding"].to(dt).expand(b, 1, width)
        x = torch.cat([cls, x], dim=1) \
            + clip_vision.positional(w, gh, gw).to(dt)
        x = norm(x, f"{p}ln_pre")
        n_layers = len({k.split(".")[2] for k in w
                        if k.startswith(f"{p}blocks.")})
        for i in range(n_layers - patches):
            x = _block(x, f"{p}blocks.{i}", heads, linear, norm, ACTS[act])
        if patches:
            last = f"{p}blocks.{n_layers - 1}"
            x = linear(linear(norm(x, f"{last}.ln_1"), f"{last}.attn.v_proj"),
                       f"{last}.attn.out_proj")
            pooled = norm(x[:, 1:], f"{p}ln_post")
        else:
            pooled = norm(x[:, 0], f"{p}ln_post")
        return (q8(pooled) @ q8(w[f"{p}proj"].to(dt))).float()


def encode_text(w: Dict[str, torch.Tensor], tokens: torch.Tensor,
                heads: int, precision: str = "bf16",
                act: str = "gelu") -> torch.Tensor:
    """(B, T) tokens -> (B, embed_dim) float32 text features
    (``TextTransformer.forward``)."""
    dt, q8, linear, norm = _ops(w, precision)
    b, t = tokens.shape
    with no_tf32():
        x = w["token_embedding.weight"][tokens].to(dt)
        x = x + w["positional_embedding"][:t].to(dt)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        n_layers = len({k.split(".")[1] for k in w
                        if k.startswith("blocks.")})
        for i in range(n_layers):
            x = _block(x, f"blocks.{i}", heads, linear, norm, ACTS[act],
                       causal)
        x = norm(x, "ln_final")
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(-1)]
        return (q8(pooled) @ q8(w["text_projection"].to(dt))).float()


def crop_features(w, images, segs, pairs: np.ndarray, teacher: Dict,
                  ing: Dict, device, batch: int, precision: str = "bf16",
                  act: str = "gelu", heads: Optional[int] = None
                  ) -> torch.Tensor:
    """(P, E) float32 class-token features of the present (view, object)
    ``pairs``, each the mean over its prompt levels (``ingest.prompt``)."""
    dev = torch.device(device)
    levels = int(ing["crop_num_levels"])
    heads = heads or int(teacher["vision_heads"])
    run = lambda crops: encode_image(  # noqa: E731
        w, torch.stack(crops), heads, int(teacher["patch_size"]), precision,
        act)
    feats, todo = [], []
    for v, k in pairs:
        image = torch.as_tensor(images[v], device=dev)
        mask = torch.as_tensor(segs[v] == k, device=dev)
        todo += [ref.prompt(image, mask, teacher["img_resize"], lv,
                            float(ing["crop_expansion_ratio"]))
                 for lv in range(levels)]
        while len(todo) >= batch:
            feats.append(run(todo[:batch]))
            todo = todo[batch:]
    if todo:
        feats.append(run(todo))
    f = torch.cat(feats) if feats else torch.zeros(
        (0, w[f"{PREFIX}proj"].shape[1]), device=dev)
    return f.reshape(len(pairs), levels, -1).mean(1)


def queries(w_text, tokenizer, obj_info: Dict, heads: int, device,
            precision: str = "bf16", act: str = "gelu") -> torch.Tensor:
    """(n_objects + 1, E) float32 unit query features, id 0 the table
    (``ingest.queries`` through ``encode_text``)."""
    texts = ref.query_texts(obj_info)
    n = max(texts) + 1
    flat = [t for k in sorted(texts) for t in texts[k]]
    emb = encode_text(w_text, tokenizer(flat).to(device), heads, precision,
                      act)
    out = torch.zeros((n, emb.shape[1]), dtype=torch.float32, device=device)
    at = 0
    for k in sorted(texts):
        m = emb[at:at + len(texts[k])].mean(0)
        out[k] = m / m.norm()
        at += len(texts[k])
    return out


def scene(w_vision, w_text, tokenizer, data: Dict, teacher: Dict,
          ing: Dict, text_heads: int, device, batch: int,
          precision: str = "bf16", fault: Optional[str] = None) -> Dict:
    """One scene's ingest with ViT-H/14, what ``ingest.scene`` returns:
    the cloud (``sel`` the voxels written, ``doubt`` those whose writing
    hinges on a borderline visibility), the crop features, the queries,
    the view weights and the fused features; ``fault`` plants one of
    ``FAULTS``."""
    act = "quick_gelu" if fault == "quick_gelu" else teacher["activation"]
    heads = (int(teacher["vision_width"]) // 64 if fault == "heads_64"
             else int(teacher["vision_heads"]))
    n_real = max(int(k) for k in data["obj_info"]) + 1
    present = ref.present_pairs(data["segs"], int(ing["max_objects"]))
    pairs = np.argwhere(present)
    v = present.shape[0]
    with torch.no_grad():
        feats = crop_features(w_vision, data["images"], data["segs"], pairs,
                              teacher, ing, device, batch, precision, act,
                              heads)
        query = queries(w_text, tokenizer, data["obj_info"], text_heads,
                        device, precision, act)
        grid = torch.zeros((v, n_real, feats.shape[1]), dtype=torch.float32,
                           device=feats.device)
        pres = torch.zeros((v, n_real), dtype=torch.bool,
                           device=feats.device)
        grid[pairs[:, 0], pairs[:, 1]] = feats
        pres[pairs[:, 0], pairs[:, 1]] = True
        wgt, m = ref.fuse(grid, pres, query,
                          use_similarity=bool(ing["use_similarity"]))
        fused = ref.weighted_mean(grid, wgt)
        out = torch.where(torch.isnan(fused).any(-1, keepdim=True),
                          query.double(), fused)
        c = ref.cloud(data["depths"], data["segs"], data["poses"], data["K"],
                      float(ing["voxel_size"]), float(ing["depth_trunc_m"]),
                      device)
        vis, border = ref.visibility(c["xyz"], data["depths"], data["poses"],
                                     data["K"], float(ing["vis_threshold"]))
    obj = c["label"] != 0
    sel = obj & vis.any(0)
    doubt = obj & ~(vis & ~border).any(0) & border.any(0)
    return dict(key=c["key"], xyz=c["xyz"], label=c["label"], vis=vis,
                border=border, sel=sel, doubt=doubt, feats=grid,
                present=pres, query=query, weights=wgt, margins=m,
                fused=fused, obj_feats=out)


# planted faults: quick-GELU in GELU's place in both towers; the vision
# tower split into heads of 64 (20 at width 1280) in place of 16 of 80
FAULTS = ("quick_gelu", "heads_64")
