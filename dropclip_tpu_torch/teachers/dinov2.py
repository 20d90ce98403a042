"""DINOv2 vision transformer in PyTorch (the optional second teacher).

Port of ``dropclip_tpu/teachers/dinov2.py`` (reference
models/features/dino/dinov2_vit_extractor.py:42-483): a stride-14 patch
embed with bias and a cls token, additive position embeddings resized
bicubically for other grids, pre-norm blocks with LayerScale on both
branches, an exact-GELU MLP (or the giant's SwiGLU), a final LayerNorm.
Inputs are NHWC, as in the JAX package.

Attention goes through ``ops.attention.attend``: K3 where the JAX
package's ``supports_packed`` holds, else K4 where ``supports`` holds,
else K5, as ``dinov2.py:47-70`` routes them (ViT-L/14 in bf16: T = 769 at
336x448 is K3, T = 1370 at 518x518 K4, T = 3073 at 672x896 K5). The
residual stream always runs the fused form (``dinov2.py:89-110``, behind
``DROPCLIP_FUSED_ADD_LN`` there): each residual add rides in the next
LayerNorm's K7 pass, the first ``norm1`` and the final ``norm`` are K6.
Per forward that is 2 K6 and 2 * layers - 1 K7 launches. Linear layers
and the patch conv are stored in the compute dtype, LayerNorm runs in
float32.

Weights come from HuggingFace ``Dinov2Model`` state dicts
(``from_hf_dinov2``) or from a flax tree (``convert.dinov2_state_dict``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..ops import attention as attn_ops
from ..ops.resize import bicubic_resize, resize_image
from .clip import LayerNormF32, _cast_linears_, _init_
from .prompting import normalize

DINO_MEAN = (0.485, 0.456, 0.406)
DINO_STD = (0.229, 0.224, 0.225)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)
        self.out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(attn_ops.attend(self.query(x), self.key(x),
                                        self.value(x), self.heads))


def swiglu_hidden(width: int, mlp_ratio: float) -> int:
    """SwiGLUFFNFused's hidden width: 2/3 of the MLP's, 8-aligned."""
    return (int(int(width * mlp_ratio) * 2 / 3) + 7) // 8 * 8


class Block(nn.Module):
    """Pre-norm block with LayerScale ``ls1``/``ls2``; ``ffn`` "mlp"
    (S/B/L) or "swiglu" (the giant)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 ffn: str = "mlp"):
        super().__init__()
        self.ffn = ffn
        self.norm1 = LayerNormF32(width, eps=1e-6)
        self.attn = Attention(width, heads)
        self.ls1 = nn.Parameter(torch.ones(width))
        self.norm2 = LayerNormF32(width, eps=1e-6)
        self.ls2 = nn.Parameter(torch.ones(width))
        if ffn == "swiglu":
            hidden = swiglu_hidden(width, mlp_ratio)
            self.w12 = nn.Linear(width, 2 * hidden)
            self.w3 = nn.Linear(hidden, width)
        else:
            self.fc1 = nn.Linear(width, int(width * mlp_ratio))
            self.fc2 = nn.Linear(int(width * mlp_ratio), width)

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        if self.ffn == "swiglu":
            x1, x2 = self.w12(h).chunk(2, dim=-1)
            return self.w3(F.silu(x1.float()).to(h.dtype) * x2)
        return self.fc2(F.gelu(self.fc1(h).float()).to(h.dtype))

    def forward(self, res: torch.Tensor, delta: Optional[torch.Tensor]):
        """Fused-stream form: the logical input is ``res + delta`` (delta
        None for the first block); returns the next (res, delta)."""
        if delta is None:
            s, h = res, self.norm1(res)
        else:
            s, h = self.norm1(res, delta)
        s, h = self.norm2(s, self.attn(h) * self.ls1.to(s.dtype))
        return s, self._mlp(h) * self.ls2.to(s.dtype)


class DinoV2ViT(nn.Module):
    """forward(pixels NHWC, normalised) -> (cls (B, D), patches
    (B, h, w, D))."""

    def __init__(self, width: int = 384, layers: int = 12, heads: int = 6,
                 patch_size: int = 14, image_resolution: int = 518,
                 mlp_ratio: float = 4.0, ffn: str = "mlp",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.patch_size = width, patch_size
        self.image_resolution, self.dtype = image_resolution, dtype
        self.layers, self.heads = layers, heads
        grid = image_resolution // patch_size
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, width))
        self.blocks = nn.ModuleList(Block(width, heads, mlp_ratio, ffn)
                                    for _ in range(layers))
        self.norm = LayerNormF32(width, eps=1e-6)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initializers' scales: lecun-normal kernels, zero
        biases and cls token, pos embed at std 0.02, unit LayerScale."""
        with torch.no_grad():
            _init_(self, generator)
            self.cls_token.zero_()
            self.pos_embed.copy_(0.02 * torch.randn(self.pos_embed.shape,
                                                    generator=generator))
            for blk in self.blocks:
                blk.ls1.fill_(1.0)
                blk.ls2.fill_(1.0)

    def _interp_pos(self, gh: int, gw: int) -> torch.Tensor:
        og = self.image_resolution // self.patch_size
        pe = self.pos_embed
        if gh == og and gw == og:
            return pe
        resized = bicubic_resize(pe[0, 1:].reshape(og, og, self.width),
                                 (gh, gw))
        return torch.cat([pe[:, :1], resized.reshape(1, gh * gw, self.width)],
                         dim=1)

    def _embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """The patch conv with the flax Conv's SAME padding."""
        x = pixels.to(self.dtype).permute(0, 3, 1, 2)
        p = self.patch_size
        ph, pw = (-x.shape[2]) % p, (-x.shape[3]) % p
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return self.patch_embed(x)

    def forward(self, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._embed(pixels)
        b, _, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1)
        x = x + self._interp_pos(gh, gw).to(x.dtype)
        res, delta = x, None
        for blk in self.blocks:
            res, delta = blk(res, delta)
        # the final norm returns float32, as the JAX package's does
        x = self.norm((res if delta is None else res + delta).float())
        return x[:, 0], x[:, 1:].reshape(b, gh, gw, self.width)


DINOV2_CONFIGS = {
    "dinov2_vits14": dict(width=384, layers=12, heads=6),
    "dinov2_vitb14": dict(width=768, layers=12, heads=12),
    "dinov2_vitl14": dict(width=1024, layers=24, heads=16),
    "dinov2_vitg14": dict(width=1536, layers=40, heads=24, ffn="swiglu"),
    "tiny-test": dict(width=64, layers=2, heads=4, image_resolution=28),
}


def build_dinov2(name: str, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None,
                 **overrides) -> DinoV2ViT:
    """DINOv2 config ``name`` (fields replaced by ``overrides``, e.g.
    ``layers=2``) with weights drawn from ``generator``, linear layers and
    the patch conv stored in ``dtype``, on ``device`` (the card unless the
    caller passes ``device="cpu"``). Load real weights with
    ``from_hf_dinov2`` + ``load_state_dict``."""
    if name not in DINOV2_CONFIGS:
        raise ValueError(f"unknown DINOv2 config {name!r}")
    device = resolve_device(device)
    model = DinoV2ViT(dtype=dtype, **{**DINOV2_CONFIGS[name], **overrides})
    model.reset_parameters(generator)
    _cast_linears_(model, dtype)
    return model.to(device).eval()


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def from_hf_dinov2(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """HuggingFace ``Dinov2Model.state_dict()`` -> ``DinoV2ViT``'s state
    dict (float32)."""
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd
                       if k.startswith("encoder.layer."))
    out = {
        "patch_embed.weight": _t(
            sd["embeddings.patch_embeddings.projection.weight"]),
        "patch_embed.bias": _t(
            sd["embeddings.patch_embeddings.projection.bias"]),
        "cls_token": _t(sd["embeddings.cls_token"]),
        "pos_embed": _t(sd["embeddings.position_embeddings"]),
        "norm.scale": _t(sd["layernorm.weight"]),
        "norm.bias": _t(sd["layernorm.bias"]),
    }
    for i in range(n_layers):
        src, dst = f"encoder.layer.{i}", f"blocks.{i}"
        names = {"norm1": "norm1", "norm2": "norm2",
                 "attn.query": "attention.attention.query",
                 "attn.key": "attention.attention.key",
                 "attn.value": "attention.attention.value",
                 "attn.out": "attention.output.dense"}
        if f"{src}.mlp.weights_in.weight" in sd:  # giant: SwiGLU
            names.update({"w12": "mlp.weights_in", "w3": "mlp.weights_out"})
        else:
            names.update({"fc1": "mlp.fc1", "fc2": "mlp.fc2"})
        for port, theirs in names.items():
            leaf = "scale" if port.startswith("norm") else "weight"
            out[f"{dst}.{port}.{leaf}"] = _t(sd[f"{src}.{theirs}.weight"])
            out[f"{dst}.{port}.bias"] = _t(sd[f"{src}.{theirs}.bias"])
        out[f"{dst}.ls1"] = _t(sd[f"{src}.layer_scale1.lambda1"])
        out[f"{dst}.ls2"] = _t(sd[f"{src}.layer_scale2.lambda1"])
    return out


def synthetic_hf_dinov2_state_dict(name: str, seed: int = 0,
                                   **overrides) -> Dict[str, torch.Tensor]:
    """A HuggingFace ``Dinov2Model``-layout state dict of config ``name``
    with weights drawn by numpy from ``seed`` (dense and conv weights at
    std fan_in^-0.5, unit LayerNorms with 10% noise, LayerScale near 0.5,
    pos embed at std 0.02): a checkpoint file that has to exist without a
    download."""
    import numpy as np

    c = {**dict(width=384, layers=12, heads=6, patch_size=14,
                image_resolution=518, mlp_ratio=4.0, ffn="mlp"),
         **DINOV2_CONFIGS[name], **overrides}
    rng = np.random.default_rng(seed)

    def draw(*shape, std=1.0, mean=0.0):
        x = rng.standard_normal(shape, dtype=np.float32) * std + mean
        return torch.from_numpy(x)

    w, p = c["width"], c["patch_size"]
    grid = c["image_resolution"] // p
    sd = {"embeddings.cls_token": draw(1, 1, w, std=0.02),
          "embeddings.mask_token": torch.zeros(1, w),
          "embeddings.position_embeddings": draw(1, grid * grid + 1, w,
                                                 std=0.02),
          "embeddings.patch_embeddings.projection.weight": draw(
              w, 3, p, p, std=(3 * p * p) ** -0.5),
          "embeddings.patch_embeddings.projection.bias": draw(w, std=0.02)}

    def lin(key, o, n):
        sd[f"{key}.weight"] = draw(o, n, std=n ** -0.5)
        sd[f"{key}.bias"] = draw(o, std=0.02)

    def ln(key):
        sd[f"{key}.weight"] = draw(w, std=0.1, mean=1.0)
        sd[f"{key}.bias"] = draw(w, std=0.1)

    hid = int(w * c["mlp_ratio"])
    for i in range(c["layers"]):
        s = f"encoder.layer.{i}"
        ln(f"{s}.norm1")
        for n in ("query", "key", "value"):
            lin(f"{s}.attention.attention.{n}", w, w)
        lin(f"{s}.attention.output.dense", w, w)
        sd[f"{s}.layer_scale1.lambda1"] = draw(w, std=0.1, mean=0.5)
        ln(f"{s}.norm2")
        if c["ffn"] == "swiglu":
            h = swiglu_hidden(w, c["mlp_ratio"])
            lin(f"{s}.mlp.weights_in", 2 * h, w)
            lin(f"{s}.mlp.weights_out", w, h)
        else:
            lin(f"{s}.mlp.fc1", hid, w)
            lin(f"{s}.mlp.fc2", w, hid)
        sd[f"{s}.layer_scale2.lambda1"] = draw(w, std=0.1, mean=0.5)
    ln("layernorm")
    return sd


class Dinov2Extractor:
    """The featurizer API over ``DinoV2ViT`` (reference
    dinov2_vit_extractor.py:439-483): cls or patch mode, DINO
    normalisation, batches of ``batch_size``. The model is on its device
    already; inputs move there."""

    def __init__(self, model: DinoV2ViT, mode: str = "patch",
                 img_resize: Tuple[int, int] = (336, 448),
                 batch_size: int = 32):
        self.model = model
        self.device = next(model.parameters()).device
        self.img_resize = tuple(img_resize)
        self.batch_size = batch_size
        self.set_mode(mode)

    def set_mode(self, mode: str) -> None:
        if mode not in ("cls", "patch"):
            raise ValueError("Set mode to either ['cls', 'patch']")
        self.mode = mode

    def get_cls_token(self, images) -> torch.Tensor:
        return self._run(images)[0]

    def get_patch_tokens(self, images) -> torch.Tensor:
        return self._run(images)[1]

    def extract(self, images) -> torch.Tensor:
        out = self._run(images)
        return out[0] if self.mode == "cls" else out[1]

    @torch.no_grad()
    def _run(self, images):
        """Images (N, H, W, 3) 0..255 -> (cls (N, D), patches
        (N, h, w, D))."""
        images = torch.as_tensor(images).to(self.device)
        cls_out, patch_out = [], []
        for i in range(0, images.shape[0], self.batch_size):
            x = resize_image(images[i: i + self.batch_size].float(),
                             self.img_resize)
            c, p = self.model(normalize(x / 255.0, DINO_MEAN, DINO_STD))
            cls_out.append(c)
            patch_out.append(p)
        return torch.cat(cls_out), torch.cat(patch_out)
