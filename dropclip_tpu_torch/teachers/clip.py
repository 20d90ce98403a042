"""CLIP's text tower (causal transformer, EOT pooling) in PyTorch.

Port of the text side of ``dropclip_tpu/teachers/clip.py`` (reference
models/features/clip/model.py:180-192, 413-426); the vision towers wait
for the ingest slice. Compute dtype follows the JAX policy: linear layers,
embeddings and the residual stream in ``dtype`` (bf16 on the serve path),
LayerNorm in float32 through ``ops.layernorm`` (K6 on the card), softmax
in float32.

Attention is plain matmul + masked softmax, matching
``jax.nn.dot_product_attention(is_causal=True)``: logits accumulate in
float32, softmax in float32, probabilities cast to the value dtype. It
was outside any Pallas kernel in the JAX text tower, so it stays plain
torch here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layernorm import layer_norm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — OpenAI CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


class LayerNormF32(nn.Module):
    """LayerNorm computed in float32, result cast back to the input dtype;
    float32 ``scale``/``bias`` (flax names)."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, eps=self.eps)


class MultiHeadAttention(nn.Module):
    """MHA with separate q/k/v/out projections."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads
        split = lambda p: p.reshape(b, t, self.heads, hd).transpose(1, 2)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), \
            split(self.v_proj(x))
        logits = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
        if causal:
            keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNormF32(width)
        self.attn = MultiHeadAttention(width, heads)
        self.ln_2 = LayerNormF32(width)
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal=causal)
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class CLIPTextTransformer(nn.Module):
    """Causal text tower: tokens (B, T) int -> (B, embed_dim), pooled at
    the EOT token (the argmax token id)."""

    def __init__(self, width: int, layers: int, heads: int, vocab_size: int,
                 context_length: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))
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
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    normal(mod.weight, mod.in_features ** -0.5)
                    mod.bias.zero_()
                elif isinstance(mod, LayerNormF32):
                    mod.scale.fill_(1.0)
                    mod.bias.zero_()
            normal(self.text_projection,
                   self.text_projection.shape[0] ** -0.5)

    def cast_(self) -> "CLIPTextTransformer":
        """Store linear layers in the compute dtype (the JAX tower casts
        their f32 kernels to it on every call; same values)."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.to(self.dtype)
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


# Text-tower hyperparameters of the canonical CLIP configs (the vision
# fields of dropclip_tpu's CLIP_CONFIGS come with the ingest slice).
CLIP_CONFIGS = {
    "ViT-B/32": dict(embed_dim=512, context_length=77, vocab_size=49408,
                     transformer_width=512, transformer_heads=8,
                     transformer_layers=12),
    "ViT-B/16": dict(embed_dim=512, context_length=77, vocab_size=49408,
                     transformer_width=512, transformer_heads=8,
                     transformer_layers=12),
    "ViT-L/14": dict(embed_dim=768, context_length=77, vocab_size=49408,
                     transformer_width=768, transformer_heads=12,
                     transformer_layers=12),
    "ViT-L/14@336px": dict(embed_dim=768, context_length=77,
                           vocab_size=49408, transformer_width=768,
                           transformer_heads=12, transformer_layers=12),
    "RN50": dict(embed_dim=1024, context_length=77, vocab_size=49408,
                 transformer_width=512, transformer_heads=8,
                 transformer_layers=12),
    "RN101": dict(embed_dim=512, context_length=77, vocab_size=49408,
                  transformer_width=512, transformer_heads=8,
                  transformer_layers=12),
    "RN50x4": dict(embed_dim=640, context_length=77, vocab_size=49408,
                   transformer_width=640, transformer_heads=10,
                   transformer_layers=12),
    "RN50x16": dict(embed_dim=768, context_length=77, vocab_size=49408,
                    transformer_width=768, transformer_heads=12,
                    transformer_layers=12),
    "RN50x64": dict(embed_dim=1024, context_length=77, vocab_size=49408,
                    transformer_width=1024, transformer_heads=16,
                    transformer_layers=12),
    "tiny-test-rn": dict(embed_dim=16, context_length=77, vocab_size=49408,
                         transformer_width=32, transformer_heads=4,
                         transformer_layers=2),
    "tiny-test": dict(embed_dim=16, context_length=77, vocab_size=49408,
                      transformer_width=32, transformer_heads=4,
                      transformer_layers=2),
}


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
        dtype=dtype)
    model.reset_parameters(generator)
    return model.cast_().eval()
