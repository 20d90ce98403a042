"""Attention entry points of the CLIP ViT teacher: K3, K4 and K5.

Port of ``dropclip_tpu/ops/attention.py``. The three TPU kernels become
one hand-written CUDA kernel (``csrc/attention.cu``, bound in
``kernels/attention.py``), because a contiguous (B, T, H, D) tensor has
the memory layout of a packed (B, T, H*D) one:

- ``oneshot_attention_packed`` (K3): non-causal, packed (B, T, H*D) q/k/v,
  the raw projection outputs (the teacher's default route);
- ``oneshot_attention`` (K4): the same on (B, T, H, D)
  (``DROPCLIP_PACKED_ATTN=0``);
- ``flash_attention_padded`` (K5): (B, T, H, D), causal optional, any T
  (sequences past ``supports``).

Each is a wrapper: CUDA tensors launch the kernel (or raise), CPU tensors
take the plain version, and ``<entry>.launches`` counts kernel launches.
``supports`` and ``supports_packed`` are the JAX package's predicates,
kept so that a shape takes the same route as there. Their budgets are
the TPU's VMEM limits and bind nothing on the card, whose kernel takes any
T at head dims 16, 32 and 64, in bfloat16 or float32.

The plain versions of K3 and K4 follow the TPU body's order: float32
logits, ``exp2(s * scale * log2(e) - max)``, the unnormalised
probabilities rounded to the input dtype before the float32-accumulated
P.V product, then division by the float32 row sum. The plain K5 is the
contract of its CPU oracle, ``jax.nn.dot_product_attention``: float32
masked softmax, normalised probabilities rounded to the input dtype.
"""

from __future__ import annotations

import torch

LOG2E = 1.4426950408889634
_VMEM_BUDGET = 25 * 1024 * 1024
_VMEM_BUDGET_PACKED = 14 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def supports(t: int, d: int, causal: bool, itemsize: int = 2) -> bool:
    """True where the JAX package routes to the one-shot kernel (K4)."""
    tq = tk = _round_up(t, 128)
    need = tq * tk * (4 + itemsize) + 2 * (2 * tq * d + 2 * tk * d) * itemsize
    return not causal and need <= _VMEM_BUDGET


def supports_packed(t: int, heads: int, d: int, causal: bool,
                    itemsize: int = 2, group: int = 4) -> bool:
    """True where the JAX package routes to the packed kernel (K3)."""
    tq = _round_up(t, 128)
    need = (tq * tq * (4 + itemsize)
            + 2 * 4 * tq * group * d * itemsize)
    return (not causal and heads % group == 0 and d % 8 == 0
            and group * d % 128 == 0 and need <= _VMEM_BUDGET_PACKED)


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3).float()  # (B, T, H, D) -> (B, H, T, D)


def oneshot_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 (and, on reshaped views, K3): (B, T, H, D)."""
    d = q.shape[-1]
    s = _heads_first(q) @ _heads_first(k).transpose(-1, -2)
    s.mul_(d ** -0.5 * LOG2E)
    s.sub_(s.amax(-1, keepdim=True)).exp2_()
    den = s.sum(-1, keepdim=True)
    o = s.to(q.dtype).float() @ _heads_first(v)
    return (o * (1.0 / den)).to(q.dtype).permute(0, 2, 1, 3)


def oneshot_attention_packed_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, heads: int
                                   ) -> torch.Tensor:
    """Plain version of K3: packed (B, T, H*D) in and out."""
    b, t, c = q.shape
    split = lambda x: x.reshape(b, t, heads, c // heads)
    return oneshot_attention_plain(split(q), split(k), split(v)).reshape(
        b, t, c)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """Plain version of K5: masked softmax attention on (B, T, H, D)."""
    t, d = q.shape[1], q.shape[-1]
    logits = _heads_first(q) @ _heads_first(k).transpose(-1, -2)
    logits.mul_(d ** -0.5)
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        logits.masked_fill_(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = probs.float() @ _heads_first(v)
    return out.to(q.dtype).permute(0, 2, 1, 3)


def _launch(q, k, v, heads, causal):
    from ..kernels.attention import attention

    return attention(q, k, v, heads, causal)


def oneshot_attention_packed(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, heads: int) -> torch.Tensor:
    """K3: non-causal MHA on packed (B, T, H*D) q/k/v."""
    if not q.is_cuda:
        return oneshot_attention_packed_plain(q, k, v, heads)
    out = _launch(q, k, v, heads, False)
    oneshot_attention_packed.launches += 1
    return out


def oneshot_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """K4: non-causal MHA, (B, T, H, D) -> (B, T, H, D)."""
    if not q.is_cuda:
        return oneshot_attention_plain(q, k, v)
    out = _launch(q, k, v, q.shape[2], False)
    oneshot_attention.launches += 1
    return out


def flash_attention_padded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = False
                           ) -> torch.Tensor:
    """K5: MHA on (B, T, H, D) at any T, causal optional."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)
    out = _launch(q, k, v, q.shape[2], causal)
    flash_attention_padded.launches += 1
    return out


oneshot_attention_packed.launches = 0
oneshot_attention.launches = 0
flash_attention_padded.launches = 0
