"""CLIP in PyTorch: the ViT and ModifiedResNet (RN) vision towers, the
causal text tower and the ``CLIP`` wrapper.

Port of ``dropclip_tpu/teachers/clip.py`` (reference
models/features/clip/model.py:12-292, 413-443): a tuple ``vision_layers``
selects the RN tower, an int the ViT, as ``build_model`` does. Compute
dtype follows the JAX policy: linear layers, convs, embeddings and the
residual stream in ``dtype`` (bf16 on the serve and ingest paths),
LayerNorm and the RN's frozen BatchNorm in float32 (LayerNorm through
``ops.layernorm``: K6, and K7 for the fused residual add, on the card),
softmax in float32.

ViT attention goes through ``ops.attention.attend``: K3 on the packed
projections where the JAX package's ``supports_packed`` holds (and
``DROPCLIP_PACKED_ATTN`` is not 0), else K4 where ``supports`` holds, else
K5, as ``clip.py:110-138`` routes them; on CPU tensors each entry point
runs its plain version. The kernel takes bfloat16 and float32. The vision
tower always runs the fused residual stream (``fused_call``, one K7 pass
per add + LayerNorm), which is bit-identical to the unfused form that the
JAX package runs unless ``DROPCLIP_FUSED_ADD_LN`` is set.

The blocks' MLP activation is the configuration's ``activation``:
``quick_gelu`` for OpenAI's towers, ``gelu`` (exact, erf) for OpenCLIP's
ViT-H/14, in both towers.

Text attention and the RN's attention pool are plain matmul + softmax
(``dot_product_attention``), matching ``jax.nn.dot_product_attention``:
logits accumulate in float32, softmax in float32, probabilities cast to
the value dtype. Neither takes a Pallas kernel in the JAX package, and the
RN's convs and pools are XLA ops there; here they are ``F.conv2d`` and
``F.avg_pool2d``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..ops import attention as attn_ops
from ..ops.layernorm import add_layer_norm, layer_norm
from ..ops.resize import bicubic_resize


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — OpenAI CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


# the blocks' MLP activation by configuration name: OpenAI's quick-GELU,
# and the exact (erf) GELU of OpenCLIP's towers (``nn.GELU``)
ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


class LayerNormF32(nn.Module):
    """LayerNorm computed in float32, result cast back to the input dtype;
    float32 ``scale``/``bias`` (flax names)."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor, delta: Optional[torch.Tensor] = None):
        """LN(x), or with ``delta`` the fused residual form
        ``(x + delta, LN(x + delta))`` (K7 on the card)."""
        if delta is not None:
            return add_layer_norm(x, delta, self.scale, self.bias,
                                  eps=self.eps)
        return layer_norm(x, self.scale, self.bias, eps=self.eps)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """Plain softmax attention on (B, H, T, D) (``jax.nn.dot_product_
    attention``'s arithmetic): float32 logits and softmax, probabilities
    rounded to the value dtype."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        t, s = logits.shape[-2:]
        keep = torch.ones(t, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    return torch.softmax(logits, dim=-1).to(v.dtype) @ v


class MultiHeadAttention(nn.Module):
    """MHA with separate q/k/v/out projections. ``use_kernels`` routes
    through ``ops.attention.attend`` (the vision tower); otherwise plain
    attention (the text tower)."""

    def __init__(self, width: int, heads: int, use_kernels: bool = False):
        super().__init__()
        self.heads = heads
        self.use_kernels = use_kernels
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        if self.use_kernels:
            return self.out_proj(attn_ops.attend(
                self.q_proj(x), self.k_proj(x), self.v_proj(x), self.heads,
                causal))
        b, t, d = x.shape
        split = lambda p: p.reshape(b, t, self.heads, -1).transpose(1, 2)
        out = dot_product_attention(split(self.q_proj(x)),
                                    split(self.k_proj(x)),
                                    split(self.v_proj(x)), causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))

    def value_path(self, x: torch.Tensor) -> torch.Tensor:
        """out_proj(V-projection(x)) — the MaskCLIP trick."""
        return self.out_proj(self.v_proj(x))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, use_kernels: bool = False,
                 activation: str = "quick_gelu"):
        super().__init__()
        self.ln_1 = LayerNormF32(width)
        self.attn = MultiHeadAttention(width, heads, use_kernels)
        self.ln_2 = LayerNormF32(width)
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)
        self.act = ACTIVATIONS[activation]

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal=causal)
        return x + self.c_proj(self.act(self.c_fc(self.ln_2(x))))

    def fused_call(self, res: torch.Tensor, delta: Optional[torch.Tensor],
                   causal: bool = False):
        """Fused-stream form: the logical input is ``res + delta`` (delta
        None for the first block); each residual add rides inside the
        next add + LayerNorm pass. The caller ends with one plain add."""
        if delta is None:
            s, y = res, self.ln_1(res)
        else:
            s, y = self.ln_1(res, delta)
        s, y = self.ln_2(s, self.attn(y, causal=causal))
        return s, self.c_proj(self.act(self.c_fc(y)))

    def forward_v(self, x: torch.Tensor) -> torch.Tensor:
        """Value path only; no residual, no MLP."""
        return self.attn.value_path(self.ln_1(x))


def _init_(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Flax initializers' scales, drawn on the CPU in module order:
    lecun-normal dense and conv kernels, zero biases, unit LayerNorms and
    identity frozen BatchNorms."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(fan_in ** -0.5 * torch.randn(
                mod.weight.shape, generator=generator))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, LayerNormF32):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, FrozenBatchNorm):
            for p, val in ((mod.scale, 1.0), (mod.bias, 0.0),
                           (mod.mean, 0.0), (mod.var, 1.0)):
                p.fill_(val)


def _cast_linears_(module: nn.Module, dtype: torch.dtype) -> None:
    """Store linear layers and convs in the compute dtype (the JAX towers
    cast their float32 kernels to it on every call; same values)."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            mod.to(dtype)


class CLIPVisionTransformer(nn.Module):
    """ViT tower: pixels NHWC (B, H, W, 3) -> (B, embed_dim) class-token
    features, or (B, n_patches, embed_dim) MaskCLIP patch features with
    ``patch_output``. ``conv1`` is the patch embedding as a bias-free
    linear layer over unfolded (kh, kw, c) patches: stride equals kernel,
    so it is the flax Conv's product exactly (with its SAME padding)."""

    def __init__(self, width: int, layers: int, heads: int, patch_size: int,
                 embed_dim: int, image_resolution: int,
                 dtype: torch.dtype = torch.float32,
                 activation: str = "quick_gelu"):
        super().__init__()
        self.width, self.patch_size = width, patch_size
        self.image_resolution = image_resolution
        self.dtype = dtype
        grid = image_resolution // patch_size
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(grid * grid + 1, width))
        self.conv1 = nn.Linear(patch_size * patch_size * 3, width,
                               bias=False)
        self.ln_pre = LayerNormF32(width)
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, use_kernels=True,
                                   activation=activation)
            for _ in range(layers))
        self.ln_post = LayerNormF32(width)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        scale = self.width ** -0.5
        with torch.no_grad():
            for p in (self.class_embedding, self.positional_embedding):
                p.copy_(scale * torch.randn(p.shape, generator=generator))
            _init_(self, generator)
            self.proj.copy_(scale * torch.randn(self.proj.shape,
                                                generator=generator))

    def _interpolated_pos_embed(self, grid_h: int, grid_w: int
                                ) -> torch.Tensor:
        """Bicubic pos-embed resampling with the DINO +0.1 trick."""
        pe = self.positional_embedding
        og = self.image_resolution // self.patch_size
        if grid_h == og and grid_w == og:
            return pe
        resized = bicubic_resize(
            pe[1:].reshape(og, og, self.width), (grid_h, grid_w),
            scale_hw=((grid_h + 0.1) / og, (grid_w + 0.1) / og))
        return torch.cat([pe[:1], resized.reshape(-1, self.width)], dim=0)

    def _patches(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, gh, gw, p*p*3) in (kh, kw, c) order, zero
        padded as the flax Conv's SAME padding."""
        b, h, w, c = pixels.shape
        p = self.patch_size
        gh, gw = -(-h // p), -(-w // p)
        ph, pw = gh * p - h, gw * p - w
        if ph or pw:
            pixels = nn.functional.pad(
                pixels, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        x = pixels.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh, gw, p * p * c)

    def _embed(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.conv1(self._patches(pixels.to(self.dtype)))
        b, gh, gw, _ = x.shape
        x = x.reshape(b, gh * gw, self.width)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1)
        x = x + self._interpolated_pos_embed(gh, gw).to(x.dtype)
        return self.ln_pre(x)

    def _run_blocks(self, x: torch.Tensor, blocks) -> torch.Tensor:
        res, delta = x, None
        for blk in blocks:
            res, delta = blk.fused_call(res, delta)
        return res if delta is None else res + delta

    def forward(self, pixels: torch.Tensor,
                patch_output: bool = False) -> torch.Tensor:
        x = self._embed(pixels)
        if patch_output:
            x = self._run_blocks(x, self.blocks[:-1])
            x = self.blocks[-1].forward_v(x)
            x = self.ln_post(x[:, 1:, :].contiguous())
            return x @ self.proj.to(x.dtype)
        x = self._run_blocks(x, self.blocks)
        x = self.ln_post(x[:, 0, :].contiguous())
        return x @ self.proj.to(x.dtype)


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm over dim 1 of NCHW with its running
    statistics as parameters (flax names ``scale``, ``bias``, ``mean``,
    ``var``); computed in float32, cast back to the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        col = lambda p: p[:, None, None]
        y = (x.float() - col(self.mean)) * torch.rsqrt(col(self.var)
                                                       + self.eps)
        return (y * col(self.scale) + col(self.bias)).to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BottleneckRN(nn.Module):
    """CLIP's anti-aliased ResNet bottleneck on NCHW: every conv at stride
    1, an average pool after conv2 when ``stride`` > 1, and the downsample
    branch led by the same pool."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), \
            FrozenBatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), \
            FrozenBatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), \
            FrozenBatchNorm(planes * 4)
        self.downsample = stride > 1 or inplanes != planes * 4
        if self.downsample:
            self.downsample_conv = _conv(inplanes, planes * 4, 1)
            self.downsample_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.stride > 1:
            y = F.avg_pool2d(y, self.stride)
        y = self.bn3(self.conv3(y))
        idn = x
        if self.downsample:
            if self.stride > 1:
                idn = F.avg_pool2d(idn, self.stride)
            idn = self.downsample_bn(self.downsample_conv(idn))
        return F.relu(y + idn)


class AttentionPool2d(nn.Module):
    """QKV attention pool whose query is the mean token, and the MaskCLIP
    value path ``forward_v`` for per-patch features. Inputs are NCHW."""

    def __init__(self, spacial_dim: int, embed_dim: int, heads: int,
                 output_dim: int):
        super().__init__()
        self.spacial_dim, self.embed_dim, self.heads = \
            spacial_dim, embed_dim, heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    @staticmethod
    def _tokens(x: torch.Tensor) -> torch.Tensor:
        """(B, C, h, w) -> (B, 1 + h*w, C): the mean token, then the grid
        row-major."""
        t = x.flatten(2).transpose(1, 2)
        return torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)

    def _pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        """Bicubic pos-embed resampling with the DINO +0.1 trick, in the
        true (h, w) orientation as the JAX package does."""
        og, pe = self.spacial_dim, self.positional_embedding
        if gh == og and gw == og:
            return pe
        resized = bicubic_resize(
            pe[1:].reshape(og, og, self.embed_dim), (gh, gw),
            scale_hw=((gh + 0.1) / og, (gw + 0.1) / og))
        return torch.cat([pe[:1], resized.reshape(-1, self.embed_dim)], 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, h, w) -> (B, output_dim). The embedding is added as it
        is, so the cls path takes only the training grid."""
        b, _, h, w = x.shape
        if h * w != self.spacial_dim ** 2:
            raise ValueError(
                f"AttentionPool2d cls path needs the {self.spacial_dim}^2 "
                f"training grid, got {h}x{w} (reference model.py:75 "
                "shape-errors identically); use patch_output for other sizes")
        t = self._tokens(x) + self.positional_embedding.to(x.dtype)
        split = lambda p: p.reshape(b, p.shape[1], self.heads, -1
                                    ).transpose(1, 2)
        out = dot_product_attention(split(self.q_proj(t[:, :1])),
                                    split(self.k_proj(t)),
                                    split(self.v_proj(t)))
        return self.c_proj(out.transpose(1, 2).reshape(b, 1, -1))[:, 0]

    def forward_v(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, h, w) -> (B, h*w + 1, output_dim): c_proj(v_proj(tokens))
        with the interpolated positional embedding."""
        t = self._tokens(x)
        t = t + self._pos_embed(x.shape[2], x.shape[3]).to(t.dtype)
        return self.c_proj(self.v_proj(t))


class ModifiedResNet(nn.Module):
    """CLIP's RN tower: pixels NHWC (B, H, W, 3) -> (B, output_dim) pooled
    features, or the MaskCLIP value-path features (B, h*w, output_dim)
    with ``patch_output``. Stage blocks keep the flax names
    ``layer{stage}_{index}``."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int, width: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1, self.bn1 = _conv(3, width // 2, 3, 2), \
            FrozenBatchNorm(width // 2)
        self.conv2, self.bn2 = _conv(width // 2, width // 2, 3), \
            FrozenBatchNorm(width // 2)
        self.conv3, self.bn3 = _conv(width // 2, width, 3), \
            FrozenBatchNorm(width)
        self.stage_names = []
        inplanes = width
        for j, n in enumerate(layers):
            planes = width * 2 ** j
            for i in range(n):
                name = f"layer{j + 1}_{i}"
                self.add_module(name, BottleneckRN(
                    inplanes, planes, 2 if (i == 0 and j > 0) else 1))
                self.stage_names.append(name)
                inplanes = planes * 4
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32,
                                        heads, output_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            _init_(self, generator)
            pe = self.attnpool.positional_embedding
            pe.copy_(self.attnpool.embed_dim ** -0.5 * torch.randn(
                pe.shape, generator=generator))

    def forward(self, pixels: torch.Tensor,
                patch_output: bool = False) -> torch.Tensor:
        x = pixels.to(self.dtype).permute(0, 3, 1, 2)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = F.relu(bn(conv(x)))
        x = F.avg_pool2d(x, 2)
        for name in self.stage_names:
            x = getattr(self, name)(x)
        if patch_output:  # c_proj already maps to output_dim: no proj
            return self.attnpool.forward_v(x)[:, 1:, :]
        return self.attnpool(x)


class CLIPTextTransformer(nn.Module):
    """Causal text tower: tokens (B, T) int -> (B, embed_dim), pooled at
    the EOT token (the argmax token id)."""

    def __init__(self, width: int, layers: int, heads: int, vocab_size: int,
                 context_length: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32,
                 activation: str = "quick_gelu"):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, activation=activation)
            for _ in range(layers))
        self.ln_final = LayerNormF32(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Seeded init with the flax initializers' scales (normal 0.02 /
        0.01 embeddings, lecun-normal dense kernels, zero biases, unit LN),
        drawn on the CPU in module order."""
        def normal(p, std):
            p.copy_(std * torch.randn(p.shape, generator=generator))

        with torch.no_grad():
            normal(self.token_embedding.weight, 0.02)
            normal(self.positional_embedding, 0.01)
            _init_(self, generator)
            normal(self.text_projection,
                   self.text_projection.shape[0] ** -0.5)

    def cast_(self) -> "CLIPTextTransformer":
        """Store linear layers in the compute dtype."""
        _cast_linears_(self, self.dtype)
        return self

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[1]
        x = self.token_embedding(tokens.long()).to(self.dtype)
        x = x + self.positional_embedding[:t].to(self.dtype)
        for blk in self.blocks:
            x = blk(x, causal=True)
        x = self.ln_final(x)
        eot = tokens.long().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(pooled.dtype)


class CLIP(nn.Module):
    """Full CLIP: ``encode_image`` (class-token or pooled features),
    ``get_patch_encodings`` (MaskCLIP patch features), ``encode_text``.
    Fields are those of ``CLIP_CONFIGS``: an int ``vision_layers`` builds
    the ViT tower, a tuple of four stage depths the RN tower (whose
    ``vision_patch_size`` is its output stride, 32); ``vision_heads``
    defaults to heads of 64 (OpenAI's rule), ``activation`` (a key of
    ``ACTIVATIONS``) is both towers' MLP activation, and ``img_resize``
    the (H, W) crop canvas the ingest teacher takes (the recipe's
    336 x 448)."""

    def __init__(self, embed_dim: int, image_resolution: int,
                 vision_layers, vision_width: int, vision_patch_size: int,
                 context_length: int, vocab_size: int,
                 transformer_width: int, transformer_heads: int,
                 transformer_layers: int, vision_heads: Optional[int] = None,
                 activation: str = "quick_gelu",
                 img_resize: Tuple[int, int] = (336, 448),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_resolution = image_resolution
        self.img_resize = tuple(img_resize)
        self.vision_patch_size = vision_patch_size
        self.context_length = context_length
        self.dtype = dtype
        if isinstance(vision_layers, (tuple, list)):
            self.visual = ModifiedResNet(
                layers=tuple(vision_layers), output_dim=embed_dim,
                heads=vision_heads or vision_width * 32 // 64,
                input_resolution=image_resolution, width=vision_width,
                dtype=dtype)
        else:
            self.visual = CLIPVisionTransformer(
                width=vision_width, layers=vision_layers,
                heads=vision_heads or vision_width // 64,
                patch_size=vision_patch_size, embed_dim=embed_dim,
                image_resolution=image_resolution, dtype=dtype,
                activation=activation)
        self.text = CLIPTextTransformer(
            width=transformer_width, layers=transformer_layers,
            heads=transformer_heads, vocab_size=vocab_size,
            context_length=context_length, embed_dim=embed_dim, dtype=dtype,
            activation=activation)
        self.logit_scale = nn.Parameter(torch.tensor(2.6592))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.visual.reset_parameters(generator)
        self.text.reset_parameters(generator)
        with torch.no_grad():
            self.logit_scale.fill_(2.6592)

    def cast_(self) -> "CLIP":
        """Store linear layers in the compute dtype."""
        _cast_linears_(self, self.dtype)
        return self

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual(pixels)

    def get_patch_encodings(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual(pixels, patch_output=True)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)


# Canonical CLIP configs (reference clip.py:_MODELS; the ingest teacher is
# ViT-L/14@336px) and OpenCLIP's ViT-H/14. For the RN entries
# vision_patch_size is the output stride.
CLIP_CONFIGS = {
    "ViT-B/32": dict(embed_dim=512, image_resolution=224, vision_layers=12,
                     vision_width=768, vision_patch_size=32,
                     context_length=77, vocab_size=49408,
                     transformer_width=512, transformer_heads=8,
                     transformer_layers=12, activation="quick_gelu"),
    "ViT-B/16": dict(embed_dim=512, image_resolution=224, vision_layers=12,
                     vision_width=768, vision_patch_size=16,
                     context_length=77, vocab_size=49408,
                     transformer_width=512, transformer_heads=8,
                     transformer_layers=12, activation="quick_gelu"),
    "ViT-L/14": dict(embed_dim=768, image_resolution=224, vision_layers=24,
                     vision_width=1024, vision_patch_size=14,
                     context_length=77, vocab_size=49408,
                     transformer_width=768, transformer_heads=12,
                     transformer_layers=12, activation="quick_gelu"),
    "ViT-L/14@336px": dict(embed_dim=768, image_resolution=336,
                           vision_layers=24, vision_width=1024,
                           vision_patch_size=14, context_length=77,
                           vocab_size=49408, transformer_width=768,
                           transformer_heads=12, transformer_layers=12,
                           activation="quick_gelu"),
    "RN50": dict(embed_dim=1024, image_resolution=224,
                 vision_layers=(3, 4, 6, 3), vision_width=64,
                 vision_patch_size=32, context_length=77, vocab_size=49408,
                 transformer_width=512, transformer_heads=8,
                 transformer_layers=12, activation="quick_gelu"),
    "RN101": dict(embed_dim=512, image_resolution=224,
                  vision_layers=(3, 4, 23, 3), vision_width=64,
                  vision_patch_size=32, context_length=77, vocab_size=49408,
                  transformer_width=512, transformer_heads=8,
                  transformer_layers=12, activation="quick_gelu"),
    "RN50x4": dict(embed_dim=640, image_resolution=288,
                   vision_layers=(4, 6, 10, 6), vision_width=80,
                   vision_patch_size=32, context_length=77,
                   vocab_size=49408, transformer_width=640,
                   transformer_heads=10, transformer_layers=12,
                   activation="quick_gelu"),
    "RN50x16": dict(embed_dim=768, image_resolution=384,
                    vision_layers=(6, 8, 18, 8), vision_width=96,
                    vision_patch_size=32, context_length=77,
                    vocab_size=49408, transformer_width=768,
                    transformer_heads=12, transformer_layers=12,
                    activation="quick_gelu"),
    "RN50x64": dict(embed_dim=1024, image_resolution=448,
                    vision_layers=(3, 15, 36, 10), vision_width=128,
                    vision_patch_size=32, context_length=77,
                    vocab_size=49408, transformer_width=1024,
                    transformer_heads=16, transformer_layers=12,
                    activation="quick_gelu"),
    # OpenCLIP ViT-H/14 (laion2b_s32b_b79k; open_clip's
    # model_configs/ViT-H-14.json): 16 vision heads of 80 (head_width 80,
    # so not OpenAI's heads of 64), exact GELU (nn.GELU) in both towers;
    # its crop canvas is its 224 resolution on the recipe's 3:4 in whole
    # 14-pixel patches (16 x 21 + 1 = 337 tokens)
    "ViT-H-14": dict(embed_dim=1024, image_resolution=224, vision_layers=32,
                     vision_width=1280, vision_patch_size=14,
                     vision_heads=16, context_length=77, vocab_size=49408,
                     transformer_width=1024, transformer_heads=16,
                     transformer_layers=24, activation="gelu",
                     img_resize=(224, 294)),
    # random-weights smoke configs for tests (not real teachers)
    "tiny-test-rn": dict(embed_dim=16, image_resolution=64,
                         vision_layers=(1, 1, 1, 1), vision_width=16,
                         vision_patch_size=32, context_length=77,
                         vocab_size=49408, transformer_width=32,
                         transformer_heads=4, transformer_layers=2,
                         activation="quick_gelu"),
    "tiny-test-h14": dict(embed_dim=16, image_resolution=28,
                          vision_layers=2, vision_width=320,
                          vision_patch_size=14, vision_heads=4,
                          context_length=77, vocab_size=49408,
                          transformer_width=32, transformer_heads=4,
                          transformer_layers=2, activation="gelu"),
    "tiny-test": dict(embed_dim=16, image_resolution=32, vision_layers=2,
                      vision_width=64, vision_patch_size=16,
                      context_length=77, vocab_size=49408,
                      transformer_width=32, transformer_heads=4,
                      transformer_layers=2, activation="quick_gelu"),
}


def build_clip(name: str, dtype: torch.dtype = torch.float32,
               generator: Optional[torch.Generator] = None, device=None,
               **overrides) -> CLIP:
    """CLIP config ``name`` (fields replaced by ``overrides``, e.g.
    ``vision_layers=2``) with weights drawn from ``generator`` (load real
    weights with ``convert.clip_state_dict`` + ``load_state_dict``),
    linear layers stored in ``dtype``, on ``device`` (the card unless the
    caller passes ``device="cpu"``)."""
    if name not in CLIP_CONFIGS:
        raise ValueError(f"unknown CLIP config {name!r}; "
                         f"have {sorted(CLIP_CONFIGS)}")
    device = resolve_device(device)
    model = CLIP(**{**CLIP_CONFIGS[name], **overrides}, dtype=dtype)
    model.reset_parameters(generator)
    return model.cast_().to(device).eval()


def build_clip_text(name: str, dtype: torch.dtype = torch.float32,
                    generator: Optional[torch.Generator] = None
                    ) -> CLIPTextTransformer:
    """Text tower of CLIP config ``name`` with weights drawn from
    ``generator`` (load real weights with ``convert.clip_text_state_dict``
    + ``load_state_dict``), linear layers stored in ``dtype``."""
    if name not in CLIP_CONFIGS:
        raise ValueError(f"unknown CLIP config {name!r}; "
                         f"have {sorted(CLIP_CONFIGS)}")
    c = CLIP_CONFIGS[name]
    model = CLIPTextTransformer(
        width=c["transformer_width"], layers=c["transformer_layers"],
        heads=c["transformer_heads"], vocab_size=c["vocab_size"],
        context_length=c["context_length"], embed_dim=c["embed_dim"],
        dtype=dtype, activation=c["activation"])
    model.reset_parameters(generator)
    return model.cast_().eval()
