"""Binding of the attention kernel (K3, K4, K5) in ``csrc/attention.cu``.

``attention(q, k, v, heads, causal)`` launches the kernel on contiguous
bfloat16 or float32 CUDA tensors laid out as (B, T, H, D) or,
equivalently, packed (B, T, H*D), and returns a new tensor of the same
shape; it raises on anything the kernel does not take. ``instance`` picks
the kernel's instance from the type and the head dim: v3 (``wgmma``) for
bfloat16 at D = 64, d80 (``wgmma`` on no-swizzle tiles) for bfloat16 at
D = 80, v2 (``mma.sync``) for bfloat16 at D = 16 and 32, and f32x3 for
float32 at D = 16, 32 and 64 (3xTF32 on the tensor cores, float32
accurate: ``wgmma`` at D = 64, ``mma.sync`` at D = 16 and 32).
``counters[instance].launches`` counts each instance's launches, beside
the three entry points' counts (``ops/attention.py``, with the plain
versions). The source's header note gives the design and the bound.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import count_launch
from .nvcc import library

HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 80), torch.float32: (16, 32, 64)}
INSTANCES = ("v3", "d80", "v2", "f32x3")


class Launches:
    """One instance's count of launches (``launches``)."""

    def __init__(self):
        self.launches = 0


counters = {name: Launches() for name in INSTANCES}


def instance(dtype: torch.dtype, d: int) -> str:
    """The kernel instance that takes (dtype, head dim d): "v3", "d80",
    "v2" or "f32x3". Raises TypeError for a dtype and ValueError for a
    head dim that no instance of that dtype takes."""
    if dtype not in HEAD_DIMS:
        raise TypeError(f"dtype {dtype}: the kernel takes bfloat16 or "
                        "float32, the same for q, k, v")
    if d not in HEAD_DIMS[dtype]:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS[dtype]} for "
                         f"{dtype}")
    if dtype == torch.float32:
        return "f32x3"
    return {64: "v3", 80: "d80"}.get(d, "v2")


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.dropclip_attention, lib.dropclip_attention_f32):
        fn.argtypes = [p, p, p, p, i, i, i, i, f, i, p]
        fn.restype = i
    for fn in (lib.dropclip_attention_v3, lib.dropclip_attention_d80):
        fn.argtypes = [p, p, p, p, i, i, i, f, i, p]
        fn.restype = i
    lib.dropclip_wgmma_selftest.argtypes = [p, p, p, i, p]
    lib.dropclip_wgmma_selftest.restype = i


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
    kind = instance(q.dtype, d)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != q shape "
                             f"{tuple(q.shape)}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} dtype {x.dtype} != q dtype {q.dtype}")
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
    scale_log2 = d ** -0.5 * math.log2(math.e)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind in ("v3", "d80"):
            fn = (lib.dropclip_attention_v3 if kind == "v3"
                  else lib.dropclip_attention_d80)
            err = fn(*ptrs, b, t, heads, scale_log2, int(bool(causal)),
                     stream)
        else:
            fn = (lib.dropclip_attention_f32 if kind == "f32x3"
                  else lib.dropclip_attention)
            err = fn(*ptrs, b, t, heads, d, scale_log2, int(bool(causal)),
                     stream)
    LIB.check(err, f"attention ({kind})")
    count_launch(counters[kind])
    return out


def wgmma_selftest(a: torch.Tensor, b: torch.Tensor, mode: int
                   ) -> torch.Tensor:
    """One 64 x 64 x 64 ``wgmma`` product of bf16 CUDA matrices in float32,
    a test oracle for the shared-memory descriptors that v3 uses; the port
    never calls it. mode 0: a @ b.T with both operands K-major in shared
    memory (v3's S = Q K^T); mode 1: a @ b with a in registers and b
    MN-major in shared memory (v3's O += P V)."""
    for x in (a, b):
        if (x.shape != (64, 64) or x.dtype != torch.bfloat16 or not x.is_cuda
                or not x.is_contiguous()):
            raise ValueError("wgmma_selftest takes contiguous (64, 64) "
                             "bfloat16 CUDA matrices")
    if mode not in (0, 1):
        raise ValueError(f"mode {mode} not in (0, 1)")
    c = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    lib = LIB.load()
    with torch.cuda.device(a.device):
        err = lib.dropclip_wgmma_selftest(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), mode,
            torch.cuda.current_stream().cuda_stream)
    LIB.check(err, "wgmma_selftest")
    return c
