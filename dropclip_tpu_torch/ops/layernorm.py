"""K6: float32 LayerNorm over the last axis, as a Triton kernel.

Replaces ``dropclip_tpu/ops/layernorm.py::layer_norm`` (``_pallas_ln``,
body ``_kernel``): two-pass mean and variance in float32, then
``y * scale + bias`` and a cast back to the input dtype — the text
tower's ``LayerNormF32`` (reference models/features/clip/model.py:180-187).

Bound: a row reduction plus an elementwise pass; each row is read once
and written once, so the op is bound by memory bytes (2 * rows * C *
itemsize), never by arithmetic (~9 flops per element). Design: one
program per row; the whole row (768 wide in ViT-L's text tower) sits in
one power-of-two block with a mask, so the two passes over it run from
registers and the row crosses device memory once each way.

``layer_norm`` is the wrapper: CUDA tensors launch the kernel (or raise),
CPU tensors take the plain version ``layer_norm_plain``.
``layer_norm.launches`` counts kernel launches. ``triton`` is imported
when the kernel is first built, never at module import.
"""

import torch

_kernel = None


# Triton reads the string annotation; ``tl`` is bound by ``_build``.
def _ln_rows(x_ptr, s_ptr, b_ptr, y_ptr, n_cols, eps,
             BLOCK: "tl.constexpr"):  # noqa: F821
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    inb = cols < n_cols
    base = row.to(tl.int64) * n_cols
    x = tl.load(x_ptr + base + cols, mask=inb, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / n_cols
    xc = tl.where(inb, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / n_cols
    rstd = tl.rsqrt(var + eps)
    s = tl.load(s_ptr + cols, mask=inb, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + cols, mask=inb, other=0.0).to(tl.float32)
    y = xc * rstd * s + b
    tl.store(y_ptr + base + cols, y.to(y_ptr.dtype.element_ty), mask=inb)


def _build():
    """JIT-wrap the kernel on first use (imports triton here)."""
    global _kernel, tl
    if _kernel is None:
        import triton
        import triton.language as tl  # noqa: F811 — read by _ln_rows

        _kernel = triton.jit(_ln_rows)
    return _kernel


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K6 (the JAX function's two-pass branch)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """float32-computed LayerNorm over the last axis, result in x.dtype.
    CUDA tensors run K6, CPU tensors the plain version."""
    if not x.is_cuda:
        return layer_norm_plain(x, scale, bias, eps)
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must be ({c},), got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("layer_norm: x must be contiguous")
    y = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return y
    block = 1 << (c - 1).bit_length()
    kernel = _build()
    with torch.cuda.device(x.device):
        kernel[(rows,)](x, scale, bias, y, c, eps, BLOCK=block,
                        num_warps=4 if block <= 1024 else 8)
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
