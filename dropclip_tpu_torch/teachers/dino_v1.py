"""DINO v1 high-resolution ViT descriptor extractor in PyTorch.

Port of ``dropclip_tpu/teachers/dino_v1.py`` (reference
models/features/dino/dino_vit_extractor.py:17-325): dense per-patch
descriptors from a DINO v1 / timm ViT whose patch conv runs at a
``stride`` smaller than the patch (overlapping patches, a finer grid), with
facets taken from any block: ``query``/``key``/``value`` (B, h, t, d/h),
``token`` (B, t, d) and ``attn``, the post-softmax probabilities
(B, h, t, t). The forward returns the captured facets instead of hooking
them. Positional embeddings are resized bicubically to the strided grid
with the reference's +0.1 scale trick.

Attention: a layer whose ``attn`` facet is captured materialises the
float32 probabilities, as in JAX; every other layer goes through
``ops.attention.attend`` (K3 where the JAX package's ``supports_packed``
holds, else K4 where ``supports`` holds, else K5). ViT-S/8 has 6 heads,
not a multiple of K3's group of 4, so at stride 4 it runs K5: float32 at
T = 3026 (224x224) to 16130 (512x512). LayerNorms are ``LayerNormF32``
(K6; 2 per block and the final one); blocks have no LayerScale and no
fused residual stream, as in JAX.

Also ``log_bin`` (hierarchical binning as pools and clamped shifts) and
``ViTExtractor`` (descriptors, binning, ``include_cls``, saliency).
Weights convert from facebookresearch/dino state dicts (``from_dino_v1``)
or from a flax tree (``convert.dino_v1_state_dict``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..ops import attention as attn_ops
from ..ops.resize import bicubic_resize
from .clip import LayerNormF32, _cast_linears_, _init_

DINO_V1_MEAN = (0.485, 0.456, 0.406)
DINO_V1_STD = (0.229, 0.224, 0.225)
TIMM_MEAN = (0.5, 0.5, 0.5)
TIMM_STD = (0.5, 0.5, 0.5)

FACETS = ("query", "key", "value", "token", "attn")


class _Attention(nn.Module):
    """Attention with the fused qkv projection (facebookresearch/dino
    layout)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, need_attn: bool):
        b, t, d = x.shape
        hd = d // self.heads
        qkv = self.qkv(x)
        # (B, t, 3, h, hd) -> 3 x (B, h, t, hd), the reference hook's layout
        q, k, v = qkv.reshape(b, t, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        facets = {"query": q, "key": k, "value": v}
        if need_attn:
            logits = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
            probs = torch.softmax(logits, dim=-1)
            facets["attn"] = probs
            out = (probs.to(v.dtype) @ v).transpose(1, 2).reshape(b, t, d)
        else:
            q3, k3, v3 = (s.contiguous()
                          for s in qkv.reshape(b, t, 3, d).unbind(2))
            out = attn_ops.attend(q3, k3, v3, self.heads)
        return self.proj(out), facets


class _Block(nn.Module):
    """Pre-norm ViT block (no LayerScale)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNormF32(width, eps=1e-6)
        self.attn = _Attention(width, heads)
        self.norm2 = LayerNormF32(width, eps=1e-6)
        self.fc1 = nn.Linear(width, int(width * mlp_ratio))
        self.fc2 = nn.Linear(int(width * mlp_ratio), width)

    def forward(self, x: torch.Tensor, need_attn: bool):
        attn_out, facets = self.attn(self.norm1(x), need_attn)
        x = x + attn_out
        h = self.fc1(self.norm2(x))
        x = x + self.fc2(F.gelu(h.float()).to(h.dtype))
        facets["token"] = x
        return x, facets


class DinoV1ViT(nn.Module):
    """``forward(pixels NHWC, capture=((layer, facet), ...))`` ->
    ``(final tokens (B, t, D), {(layer, facet): tensor})``."""

    def __init__(self, width: int = 384, layers: int = 12, heads: int = 6,
                 patch_size: int = 8, stride: int = 8,
                 image_resolution: int = 224, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.layers, self.heads = width, layers, heads
        self.patch_size, self.stride = patch_size, stride
        self.image_resolution, self.dtype = image_resolution, dtype
        n_native = (image_resolution // patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=stride)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_native + 1, width))
        self.blocks = nn.ModuleList(_Block(width, heads, mlp_ratio)
                                    for _ in range(layers))
        self.norm = LayerNormF32(width, eps=1e-6)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initializers' scales: lecun-normal kernels, zero
        biases and cls token, pos embed at std 0.02."""
        with torch.no_grad():
            _init_(self, generator)
            self.cls_token.zero_()
            self.pos_embed.copy_(0.02 * torch.randn(self.pos_embed.shape,
                                                    generator=generator))

    def _interp_pos(self, gh: int, gw: int) -> torch.Tensor:
        og = self.image_resolution // self.patch_size
        pe = self.pos_embed
        if gh == og and gw == og:
            return pe
        # +0.1 scale trick with recompute_scale_factor=False, as the
        # reference's interpolate_pos_encoding (dino_vit_extractor.py:110-118)
        resized = bicubic_resize(
            pe[0, 1:].reshape(og, og, self.width), (gh, gw),
            scale_hw=((gh + 0.1) / og, (gw + 0.1) / og))
        return torch.cat([pe[:, :1], resized.reshape(1, gh * gw, self.width)],
                         dim=1)

    def forward(self, pixels: torch.Tensor,
                capture: Sequence[Tuple[int, str]] = ()):
        if self.patch_size % self.stride:
            raise ValueError(f"stride {self.stride} should divide "
                             f"patch_size {self.patch_size}")
        x = self.patch_embed(pixels.to(self.dtype).permute(0, 3, 1, 2))
        b, _, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1)
        x = x + self._interp_pos(gh, gw).to(x.dtype)
        captured: Dict[Tuple[int, str], torch.Tensor] = {}
        for i, blk in enumerate(self.blocks):
            x, facets = blk(x, need_attn=(i, "attn") in capture)
            for (layer, facet) in capture:
                if layer == i:
                    captured[(layer, facet)] = facets[facet]
        return self.norm(x.float()), captured  # float32, as in JAX


# reference model_type zoo (dino_vit_extractor.py:33-34, 76-81): timm
# names alias the dino architectures (weights differ, layout identical).
DINO_V1_CONFIGS = {
    "dino_vits8": dict(width=384, layers=12, heads=6, patch_size=8),
    "dino_vits16": dict(width=384, layers=12, heads=6, patch_size=16),
    "dino_vitb8": dict(width=768, layers=12, heads=12, patch_size=8),
    "dino_vitb16": dict(width=768, layers=12, heads=12, patch_size=16),
    "vit_small_patch8_224": dict(width=384, layers=12, heads=6,
                                 patch_size=8),
    "vit_small_patch16_224": dict(width=384, layers=12, heads=6,
                                  patch_size=16),
    "vit_base_patch8_224": dict(width=768, layers=12, heads=12,
                                patch_size=8),
    "vit_base_patch16_224": dict(width=768, layers=12, heads=12,
                                 patch_size=16),
    "tiny-test": dict(width=32, layers=2, heads=4, patch_size=4,
                      image_resolution=16),
    # 12 layers and 6 heads: the saliency path's layer 11 and heads
    # 0, 2, 4, 5 at toy cost
    "tiny-test-deep": dict(width=48, layers=12, heads=6, patch_size=4,
                           image_resolution=16),
}


def build_dino_v1(model_type: str, stride: int,
                  dtype: torch.dtype = torch.float32,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> DinoV1ViT:
    """DINO v1 config ``model_type`` at patch-conv ``stride`` with weights
    drawn from ``generator``, linear layers and the patch conv stored in
    ``dtype``, on ``device`` (the card unless the caller passes
    ``device="cpu"``)."""
    if model_type not in DINO_V1_CONFIGS:
        raise ValueError(f"unknown DINO v1 model_type {model_type!r}")
    device = resolve_device(device)
    model = DinoV1ViT(stride=stride, dtype=dtype,
                      **DINO_V1_CONFIGS[model_type])
    model.reset_parameters(generator)
    _cast_linears_(model, dtype)
    return model.to(device).eval()


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def from_dino_v1(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """facebookresearch/dino ViT state dict -> ``DinoV1ViT``'s state
    dict (float32)."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("blocks."))
    out = {"patch_embed.weight": _t(sd["patch_embed.proj.weight"]),
           "patch_embed.bias": _t(sd["patch_embed.proj.bias"]),
           "cls_token": _t(sd["cls_token"]),
           "pos_embed": _t(sd["pos_embed"]),
           "norm.scale": _t(sd["norm.weight"]),
           "norm.bias": _t(sd["norm.bias"])}
    for i in range(n_layers):
        p = f"blocks.{i}"
        for port, theirs in (("norm1", "norm1"), ("norm2", "norm2"),
                             ("attn.qkv", "attn.qkv"),
                             ("attn.proj", "attn.proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            leaf = "scale" if port.startswith("norm") else "weight"
            out[f"{p}.{port}.{leaf}"] = _t(sd[f"{p}.{theirs}.weight"])
            out[f"{p}.{port}.bias"] = _t(sd[f"{p}.{theirs}.bias"])
    return out


def synthetic_dino_v1_state_dict(model_type: str, seed: int = 0
                                 ) -> Dict[str, torch.Tensor]:
    """A facebookresearch/dino-layout state dict of ``model_type`` with
    weights drawn by numpy from ``seed`` (dense and conv weights at std
    fan_in^-0.5, unit LayerNorms with 10% noise, cls token and pos embed
    at std 0.2): a checkpoint that has to exist without a download."""
    c = {**dict(image_resolution=224, mlp_ratio=4.0),
         **DINO_V1_CONFIGS[model_type]}
    rng = np.random.default_rng(seed)

    def draw(*shape, std=1.0, mean=0.0):
        x = rng.standard_normal(shape, dtype=np.float32) * std + mean
        return torch.from_numpy(x)

    w, p = c["width"], c["patch_size"]
    hid = int(w * c["mlp_ratio"])
    sd = {"patch_embed.proj.weight": draw(w, 3, p, p,
                                          std=(3 * p * p) ** -0.5),
          "patch_embed.proj.bias": draw(w, std=0.02),
          "cls_token": draw(1, 1, w, std=0.2),
          "pos_embed": draw(1, (c["image_resolution"] // p) ** 2 + 1, w,
                            std=0.2)}

    def lin(key, o, n):
        sd[f"{key}.weight"] = draw(o, n, std=n ** -0.5)
        sd[f"{key}.bias"] = draw(o, std=0.02)

    def ln(key):
        sd[f"{key}.weight"] = draw(w, std=0.1, mean=1.0)
        sd[f"{key}.bias"] = draw(w, std=0.1)

    for i in range(c["layers"]):
        b = f"blocks.{i}"
        ln(f"{b}.norm1")
        lin(f"{b}.attn.qkv", 3 * w, w)
        lin(f"{b}.attn.proj", w, w)
        ln(f"{b}.norm2")
        lin(f"{b}.mlp.fc1", hid, w)
        lin(f"{b}.mlp.fc2", w, hid)
    ln("norm")
    return sd


def _sum_pool(x: torch.Tensor, win: int, pad: int) -> torch.Tensor:
    """Stride-1 sum pool over the two middle dims of (B, H, W, C), zero
    padded by ``pad``."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), win, stride=1, padding=pad,
                     count_include_pad=True) * (win * win)
    return y.permute(0, 2, 3, 1)


def log_bin(x: torch.Tensor, grid: Tuple[int, int], hierarchy: int = 2
            ) -> torch.Tensor:
    """Hierarchical log-binned descriptors (reference _log_bin :237-283).

    x: (B, h, t-1, d) per-head facet without the cls token. Returns
    (B, 1, t-1, (1 + 8*hierarchy) * h*d): per location, the centre
    descriptor and its 8 neighbours averaged over 3^k x 3^k windows at
    dilation 3^k, edge-clamped, in the reference's (k, dy, dx) order.
    """
    b, h, t1, d = x.shape
    gh, gw = grid
    assert gh * gw == t1, (grid, t1)
    # the reference's sub-descriptor channel order (d-major over heads)
    maps = x.permute(0, 2, 3, 1).reshape(b, gh, gw, d * h)
    ones = torch.ones((1, gh, gw, 1), dtype=maps.dtype, device=maps.device)
    pools = []
    for k in range(hierarchy):
        win = 3 ** k
        # AvgPool2d(count_include_pad=False): divide by the in-bounds count
        pools.append(_sum_pool(maps, win, win // 2)
                     / _sum_pool(ones, win, win // 2))
    ys = torch.arange(gh, device=maps.device)
    xs = torch.arange(gw, device=maps.device)
    parts = []
    for k in range(hierarchy):
        step = 3 ** k
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if k != 0 and dy == 0 and dx == 0:
                    continue  # the centre is binned once
                yi = (ys + dy).clamp(0, gh - 1)
                xj = (xs + dx).clamp(0, gw - 1)
                parts.append(pools[k][:, yi][:, :, xj])
    binned = torch.cat(parts, dim=-1)
    return binned.reshape(b, 1, t1, len(parts) * d * h)


class ViTExtractor:
    """Descriptor and saliency extraction (reference ViTExtractor
    :17-325). Batches are NHWC float, already normalised (see
    ``preprocess``): ``extract_descriptors`` -> (B, 1, t, d'),
    ``extract_saliency_maps`` -> (B, t-1). Weights come from
    ``state_dict`` (``from_dino_v1`` or ``convert.dino_v1_state_dict``),
    else are drawn from ``seed``."""

    def __init__(self, model_type: str = "dino_vits8", stride: int = 4,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        self.model_type = model_type
        self.model = build_dino_v1(
            model_type, stride, dtype=dtype, device=device,
            generator=torch.Generator().manual_seed(seed))
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.device = next(self.model.parameters()).device
        self.p = self.model.patch_size
        self.stride = (stride, stride)
        if "dino" in model_type or model_type.startswith("tiny-test"):
            self.mean, self.std = DINO_V1_MEAN, DINO_V1_STD
        else:
            self.mean, self.std = TIMM_MEAN, TIMM_STD
        self.load_size: Tuple[int, int] = None
        self.num_patches: Tuple[int, int] = None

    def preprocess(self, image: np.ndarray,
                   load_size: Any = None) -> np.ndarray:
        """uint8 HWC RGB -> normalised (1, H, W, 3) float32, resized with
        cv2's LANCZOS4 when ``load_size`` is given (an int sets the short
        side)."""
        if load_size is not None:
            import cv2

            if isinstance(load_size, int):
                h, w = image.shape[:2]
                s = load_size / min(h, w)
                size = (int(round(w * s)), int(round(h * s)))
            else:
                size = (int(load_size[1]), int(load_size[0]))
            image = cv2.resize(image, size, interpolation=cv2.INTER_LANCZOS4)
        x = image.astype(np.float32) / 255.0
        x = (x - np.asarray(self.mean, np.float32)) / np.asarray(
            self.std, np.float32)
        return x[None]

    @torch.no_grad()
    def _run(self, batch, layer: int, facet: str) -> torch.Tensor:
        batch = torch.as_tensor(batch).to(self.device)
        _, h, w, _ = batch.shape
        self.load_size = (h, w)
        self.num_patches = (1 + (h - self.p) // self.stride[0],
                            1 + (w - self.p) // self.stride[1])
        _, captured = self.model(batch, capture=((layer, facet),))
        return captured[(layer, facet)]

    def extract_descriptors(self, batch, layer: int = 11,
                            facet: str = "key", bin: bool = False,
                            include_cls: bool = False) -> torch.Tensor:
        """(B, H, W, 3) -> (B, 1, t, d') descriptors (reference
        :285-309)."""
        if facet not in ("key", "query", "value", "token"):
            raise ValueError(
                f"{facet} is not a supported facet for descriptors")
        if bin and include_cls:
            raise ValueError("bin=True and include_cls=True are not "
                             "supported together")
        if not 0 <= layer < self.model.layers:
            raise ValueError(f"layer {layer} out of range "
                             f"[0, {self.model.layers})")
        x = self._run(batch, layer, facet)
        if facet == "token":
            x = x[:, None]  # (B, 1, t, d)
        if not include_cls:
            x = x[:, :, 1:, :]
        if not bin:
            b, h, t, d = x.shape
            return x.permute(0, 2, 3, 1).reshape(b, t, d * h)[:, None]
        return log_bin(x, self.num_patches)

    def extract_saliency_maps(self, batch) -> torch.Tensor:
        """cls-attention saliency in [0, 1], (B, t-1) (reference
        :311-325)."""
        if self.model_type not in ("dino_vits8", "tiny-test",
                                   "tiny-test-deep"):
            raise ValueError("saliency maps are supported only for "
                             "dino_vits8 model_type")
        probs = self._run(batch, self.model.layers - 1, "attn")
        head_idxs = [i for i in (0, 2, 4, 5) if i < self.model.heads]
        cls_attn = probs[:, head_idxs, 0, 1:].mean(dim=1)  # (B, t-1)
        lo = cls_attn.amin(dim=1, keepdim=True)
        hi = cls_attn.amax(dim=1, keepdim=True)
        # a view with constant cls-attention yields zeros, not NaN
        return (cls_attn - lo) / (hi - lo).clamp_min(1e-12)
