"""K6 and K7: float32 LayerNorm over the last axis, and its fused
residual-add form, as Triton kernels.

Replaces ``dropclip_tpu/ops/layernorm.py::layer_norm`` (``_pallas_ln``,
body ``_kernel``): two-pass mean and variance in float32, then
``y * scale + bias`` and a cast back to the input dtype — the text
tower's ``LayerNormF32`` (reference models/features/clip/model.py:180-187).

Bound: a row reduction plus an elementwise pass; each row is read once
and written once, so the op is bound by memory bytes (2 * rows * C *
itemsize), never by arithmetic (~9 flops per element). Design: the whole
row sits in one power-of-two block of lanes with a mask, so the two
passes over it run from registers and the row crosses device memory once
each way. ``launch_config`` shapes the programs from the width and the
row count: at 1024 rows or more, a row of 512 lanes or fewer (DINO v1's
384) goes to one warp, two rows to a program, so no program reduces
across warps over a block whose last warp is masked; a wider row (768 in
ViT-L's text tower, 1024 in its vision tower), or one of few rows (a
text tower's 4 x 77 at 512), takes a whole program of 4 warps (8 above
1024 lanes).

K7 replaces ``dropclip_tpu/ops/layernorm.py::add_layer_norm``
(``_pallas_fused``, body ``_fused_kernel``): ``s = res + delta`` rounded to
the stream dtype, exactly as the unfused ``x + attn(...)`` add, then
``y = LN_f32(s)``; it returns ``(s, y)``. Bound: it reads two rows and
writes two, 4 * rows * C * itemsize bytes (605 MB at the ViT-L teacher's
(96*769, 1024) bf16 rows, 0.18 ms at 3.35 TB/s), against ~10 flops per
element. Design as K6, on the same launch configuration, so the residual
sum crosses device memory once instead of three times (add, then
LayerNorm reading it back).

``layer_norm`` and ``add_layer_norm`` are the wrappers: CUDA tensors
launch the kernel (or raise), CPU tensors take the plain versions
``layer_norm_plain`` and ``add_layer_norm_plain``. ``<wrapper>.launches``
counts kernel launches. ``triton`` is imported when a kernel is first
built, never at module import.
"""

import torch

# widest row (in lanes) that one warp takes whole, two rows to a program,
# and the fewest rows that take that path: below it the one-warp programs
# (4 to an SM of the H100's 132 at 1024 rows) leave the card idle, and a
# row's latency, which 4 warps cut, decides
WARP_ROW_MAX = 512
WARP_ROW_MIN_ROWS = 1024
ROWS_PER_WARP_PROGRAM = 2


def launch_config(n_rows: int, c: int):
    """(BLOCK, ROWS, num_warps) of K6's and K7's launch over ``n_rows``
    rows of width ``c``: BLOCK lanes per row (the next power of two), ROWS
    rows per program, num_warps warps per program. The dtype does not
    change it."""
    block = 1 << max(c - 1, 0).bit_length()
    if block <= WARP_ROW_MAX and n_rows >= WARP_ROW_MIN_ROWS:
        return block, ROWS_PER_WARP_PROGRAM, 1
    return block, 1, 4 if block <= 1024 else 8


# Triton reads the string annotations; ``tl`` is bound by ``_build``.
def _ln_rows(x_ptr, s_ptr, b_ptr, y_ptr, n_rows, eps,
             N_COLS: "tl.constexpr", BLOCK: "tl.constexpr",  # noqa: F821
             ROWS: "tl.constexpr"):  # noqa: F821
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)[:, None]
    cols = tl.arange(0, BLOCK)[None, :]
    inc = cols < N_COLS
    inb = (rows < n_rows) & inc
    offs = rows.to(tl.int64) * N_COLS + cols
    x = tl.load(x_ptr + offs, mask=inb, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1)[:, None] / N_COLS
    xc = tl.where(inc, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=1)[:, None] / N_COLS
    rstd = tl.rsqrt(var + eps)
    s = tl.load(s_ptr + cols, mask=inc, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + cols, mask=inc, other=0.0).to(tl.float32)
    y = xc * rstd * s + b
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=inb)


def _add_ln_rows(r_ptr, d_ptr, s_ptr, b_ptr, so_ptr, y_ptr, n_rows, eps,
                 N_COLS: "tl.constexpr", BLOCK: "tl.constexpr",  # noqa: F821
                 ROWS: "tl.constexpr"):  # noqa: F821
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)[:, None]
    cols = tl.arange(0, BLOCK)[None, :]
    inc = cols < N_COLS
    inb = (rows < n_rows) & inc
    offs = rows.to(tl.int64) * N_COLS + cols
    r = tl.load(r_ptr + offs, mask=inb, other=0.0).to(tl.float32)
    d = tl.load(d_ptr + offs, mask=inb, other=0.0).to(tl.float32)
    # the sum in the stream dtype, as the unfused add rounds it
    s = (r + d).to(so_ptr.dtype.element_ty)
    tl.store(so_ptr + offs, s, mask=inb)
    x = s.to(tl.float32)
    mean = tl.sum(x, axis=1)[:, None] / N_COLS
    xc = tl.where(inc, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=1)[:, None] / N_COLS
    rstd = tl.rsqrt(var + eps)
    sc = tl.load(s_ptr + cols, mask=inc, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + cols, mask=inc, other=0.0).to(tl.float32)
    y = xc * rstd * sc + b
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=inb)


_kernels = {}


def _build(fn):
    """JIT-wrap a kernel on first use (imports triton here)."""
    global tl
    if fn not in _kernels:
        import triton
        import triton.language as tl  # noqa: F811 — read by the kernels

        # n_rows changes between calls that share a compiled kernel
        _kernels[fn] = triton.jit(fn, do_not_specialize=["n_rows"])
    return _kernels[fn]


def _launch(fn, tensors, n_rows, c, eps):
    """One launch of ``fn`` over ``n_rows`` rows of width ``c``; the
    caller has checked that every tensor is a contiguous one on one
    card. Triton launches on the current device; the device is switched
    only when the tensors lie on another (the switch costs the host more
    than the check)."""
    if tensors[0].get_device() != torch.cuda.current_device():
        with torch.cuda.device(tensors[0].device):
            return _launch(fn, tensors, n_rows, c, eps)
    block, rows_per, warps = launch_config(n_rows, c)
    _build(fn)[(-(-n_rows // rows_per),)](
        *tensors, n_rows, eps, N_COLS=c, BLOCK=block, ROWS=rows_per,
        num_warps=warps)


def _check(x, scale, bias, name):
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must be ({c},), got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    for what, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous")
    return c


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
    c = _check(x, scale, bias, "layer_norm")
    y = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return y
    _launch(_ln_rows, (x, scale, bias, y), rows, c, eps)
    layer_norm.launches += 1
    return y


def add_layer_norm_plain(res: torch.Tensor, delta: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5):
    """Plain version of K7: the stream-dtype add, then K6's plain LN."""
    s = res + delta
    return s, layer_norm_plain(s, scale, bias, eps)


def add_layer_norm(res: torch.Tensor, delta: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5):
    """``s = res + delta; y = LayerNormF32(s)`` in one pass; returns
    ``(s, y)``. CUDA tensors run K7, CPU tensors the plain version."""
    if not res.is_cuda:
        return add_layer_norm_plain(res, delta, scale, bias, eps)
    c = _check(res, scale, bias, "add_layer_norm")
    if delta.shape != res.shape or delta.dtype != res.dtype:
        raise ValueError(f"delta {tuple(delta.shape)} {delta.dtype} must "
                         f"match res {tuple(res.shape)} {res.dtype}")
    if delta.device != res.device or not delta.is_contiguous():
        raise ValueError(f"delta must be contiguous on {res.device}")
    s = torch.empty_like(res)
    y = torch.empty_like(res)
    rows = res.numel() // c if c else 0
    if rows == 0:
        return s, y
    _launch(_add_ln_rows, (res, delta, scale, bias, s, y), rows, c, eps)
    add_layer_norm.launches += 1
    return s, y


layer_norm.launches = 0
add_layer_norm.launches = 0
