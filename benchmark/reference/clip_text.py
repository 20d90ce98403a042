"""CLIP's text tower (OpenAI's ``CLIP.encode_text``) in plain PyTorch
over a dict of weights, with OpenAI's BPE tokenizer for ASCII prompts.

The tower: token and positional embeddings, ``layers`` pre-norm residual
blocks of causal multi-head attention and a ``4 * width`` quick-GELU MLP,
a final LayerNorm, the features at the end-of-text token (the largest id)
projected by ``text_projection``. Computed as the configuration states
it, in bf16: LayerNorms in float32 rounded to bf16, linears in bf16,
attention logits and softmax in float32. ``precision`` "fp8" rounds
every linear's input and weight to float8 e4m3 (each tensor scaled to
its largest value) before the product: the control. Weight names follow
the program's tower: ``token_embedding.weight``,
``positional_embedding``, ``blocks.<i>.{ln_1,ln_2}.{scale,bias}``,
``blocks.<i>.attn.{q,k,v,out}_proj.{weight,bias}``,
``blocks.<i>.{c_fc,c_proj}.{weight,bias}``, ``ln_final.{scale,bias}``,
``text_projection``."""

from __future__ import annotations

import gzip
import re
from typing import Dict, List

import torch
import torch.nn.functional as F

_WORD = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|"
                   r"'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+")


def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class Tokenizer:
    """OpenAI's simple tokenizer for lower-cased ASCII text (no ftfy,
    no unicode classes: the prompts are ASCII)."""

    def __init__(self, vocab_path: str):
        self.byte = _bytes_to_unicode()
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {v: i for i, v in enumerate(vocab)}
        self.rank = {m: i for i, m in enumerate(merges)}

    def _bpe(self, token: str) -> List[str]:
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = [(self.rank.get(p, 1 << 30), i) for i, p in
                     enumerate(zip(word[:-1], word[1:]))]
            r, at = min(pairs)
            if r == 1 << 30:
                break
            first, second = word[at], word[at + 1]
            out, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        return word

    def __call__(self, texts: List[str], context: int = 77) -> torch.Tensor:
        out = torch.zeros((len(texts), context), dtype=torch.long)
        for row, text in enumerate(texts):
            if not text.isascii():
                raise ValueError(f"prompt {text!r} is not ASCII")
            ids = [self.ids["<|startoftext|>"]]
            for w in _WORD.findall(" ".join(text.split()).lower()):
                ids += [self.ids[p] for p in self._bpe(
                    "".join(self.byte[b] for b in w.encode()))]
            ids.append(self.ids["<|endoftext|>"])
            out[row, :len(ids)] = torch.tensor(ids)
        return out


def weight_shapes(width: int, layers: int, vocab: int, context: int,
                  embed_dim: int) -> Dict[str, tuple]:
    shapes = {"token_embedding.weight": (vocab, width),
              "positional_embedding": (context, width)}
    for i in range(layers):
        p = f"blocks.{i}"
        for ln in ("ln_1", "ln_2"):
            shapes[f"{p}.{ln}.scale"] = (width,)
            shapes[f"{p}.{ln}.bias"] = (width,)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{p}.attn.{proj}.weight"] = (width, width)
            shapes[f"{p}.attn.{proj}.bias"] = (width,)
        shapes[f"{p}.c_fc.weight"] = (4 * width, width)
        shapes[f"{p}.c_fc.bias"] = (4 * width,)
        shapes[f"{p}.c_proj.weight"] = (width, 4 * width)
        shapes[f"{p}.c_proj.bias"] = (width,)
    shapes["ln_final.scale"] = (width,)
    shapes["ln_final.bias"] = (width,)
    shapes["text_projection"] = (width, embed_dim)
    return shapes


def init(name: str, shape: tuple) -> tuple:
    """CLIP's initializer scales: normal 0.02 token and 0.01 positional
    embeddings, lecun normal linears, zero biases, unit LayerNorms, the
    projection at width ** -0.5."""
    if name == "token_embedding.weight":
        return 0.02, 0.0
    if name == "positional_embedding":
        return 0.01, 0.0
    if name == "text_projection":
        return shape[0] ** -0.5, 0.0
    if name.endswith(".weight"):
        return shape[1] ** -0.5, 0.0
    if name.endswith(".scale"):
        return 0.0, 1.0
    return 0.0, 0.0


def is_linear(name: str) -> bool:
    """A weight or bias of the blocks' linear layers (stored in bf16)."""
    return any(f".{n}." in name for n in ("q_proj", "k_proj", "v_proj",
                                          "out_proj", "c_fc", "c_proj"))


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().float().clamp(min=1e-30) / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(x.dtype)


def encode(w: Dict[str, torch.Tensor], tokens: torch.Tensor, heads: int,
           precision: str = "bf16") -> torch.Tensor:
    """(B, T) tokens -> (B, embed_dim) float32 text features."""
    dt = torch.bfloat16
    q8 = _fp8 if precision == "fp8" else (lambda t: t)

    def linear(x, name):
        return F.linear(q8(x), q8(w[f"{name}.weight"].to(dt)),
                        w[f"{name}.bias"].to(dt))

    def norm(x, name):
        return F.layer_norm(x.float(), x.shape[-1:], w[f"{name}.scale"],
                            w[f"{name}.bias"], 1e-5).to(dt)

    b, t = tokens.shape
    x = w["token_embedding.weight"][tokens].to(dt)
    x = x + w["positional_embedding"][:t].to(dt)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    n_layers = len({k.split(".")[1] for k in w if k.startswith("blocks.")})
    for i in range(n_layers):
        p = f"blocks.{i}"
        h = norm(x, f"{p}.ln_1")
        split = lambda y: y.reshape(b, t, heads, -1).transpose(1, 2)  # noqa
        q, k, v = (split(linear(h, f"{p}.attn.{n}_proj"))
                   for n in ("q", "k", "v"))
        logits = (q.float() @ k.float().transpose(-1, -2)) \
            * q.shape[-1] ** -0.5
        logits = logits.masked_fill(~causal, torch.finfo(torch.float32).min)
        a = torch.softmax(logits, -1).to(dt) @ v
        x = x + linear(a.transpose(1, 2).reshape(b, t, -1),
                       f"{p}.attn.out_proj")
        h = linear(norm(x, f"{p}.ln_2"), f"{p}.c_fc")
        x = x + linear(h * torch.sigmoid(1.702 * h), f"{p}.c_proj")
    x = norm(x, "ln_final")
    pooled = x[torch.arange(b, device=x.device), tokens.argmax(-1)]
    return (q8(pooled) @ q8(w["text_projection"].to(dt))).float()
