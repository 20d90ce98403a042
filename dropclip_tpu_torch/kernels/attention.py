"""Binding of the attention kernel (K3, K4, K5) in ``csrc/attention.cu``.

``attention(q, k, v, heads, causal)`` launches the kernel on contiguous
bfloat16 or float32 CUDA tensors laid out as (B, T, H, D) or,
equivalently, packed (B, T, H*D), and returns a new tensor of the same
shape (bfloat16 on the tensor cores, float32 on the CUDA cores); it raises on
anything the kernel does not take. The three entry points that count
launches, and their plain versions, are in ``ops/attention.py``. The
source's header note gives the design and the bound.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .nvcc import library

HEAD_DIMS = (16, 32, 64)
DTYPES = (torch.bfloat16, torch.float32)


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.dropclip_attention, lib.dropclip_attention_f32):
        fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i


LIB = library("attention", _bind)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int, causal: bool = False) -> torch.Tensor:
    """Softmax(q k^T / sqrt(D)) v per (batch, head) on the card."""
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be (B, T, H*D) or (B, T, H, D), got "
                         f"{tuple(q.shape)}")
    b, t = q.shape[0], q.shape[1]
    c = q.shape[2] if q.dim() == 3 else q.shape[2] * q.shape[3]
    if q.dim() == 4 and q.shape[2] != heads:
        raise ValueError(f"q has {q.shape[2]} heads, expected {heads}")
    if c % heads:
        raise ValueError(f"width {c} is not a multiple of {heads} heads")
    d = c // heads
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != q shape "
                             f"{tuple(q.shape)}")
        if x.dtype != q.dtype or x.dtype not in DTYPES:
            raise TypeError(f"{name} dtype {x.dtype}: the kernel takes "
                            "bfloat16 or float32, the same for q, k, v")
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if b * t * c >= 2 ** 62:
        raise ValueError("attention: tensor too large")
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    lib = LIB.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = (lib.dropclip_attention_f32 if q.dtype == torch.float32
              else lib.dropclip_attention)
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t,
            heads, d, d ** -0.5 * math.log2(math.e), int(bool(causal)),
            stream)
    LIB.check(err, "attention")
    return out
