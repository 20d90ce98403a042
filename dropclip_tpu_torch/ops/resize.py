"""Image and feature-map resizing with torch ``F.interpolate`` parity.

Port of ``dropclip_tpu/ops/resize.py``: the cubic convolution kernel with
a = -0.75, the half-pixel mapping ``src = (dst + 0.5) / scale - 0.5``,
border clamping and no antialiasing, computed in float32 as separable
gathers and weighted sums over H, then W. ``scale_hw`` overrides the
mapping scale (``recompute_scale_factor=False``), which the CLIP
positional-embedding interpolation needs for its +0.1 trick.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _cubic_weights(frac: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Weights of the 4 taps at distances (1+f, f, 1-f, 2-f); (..., 4)."""

    def w1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def w2(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return torch.stack([w2(1.0 + frac), w1(frac), w1(1.0 - frac),
                        w2(2.0 - frac)], dim=-1)


def _linear_weights(frac: torch.Tensor) -> torch.Tensor:
    return torch.stack([1.0 - frac, frac], dim=-1)


def _axis_taps(in_size: int, out_size: int, scale: Optional[float],
               kind: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tap indices (out, T) and weights (out, T) for one axis."""
    s = float(scale) if scale is not None else out_size / in_size
    dst = torch.arange(out_size, dtype=torch.float32, device=device)
    src = (dst + 0.5) / s - 0.5
    i0 = torch.floor(src)
    frac = src - i0
    i0 = i0.to(torch.int64)
    if kind == "cubic":
        weights = _cubic_weights(frac)
        offs = torch.arange(-1, 3, device=device)
    else:
        weights = _linear_weights(frac)
        offs = torch.arange(0, 2, device=device)
    idx = (i0[:, None] + offs[None, :]).clamp(0, in_size - 1)
    return idx, weights


def _resize_axis(x: torch.Tensor, axis: int, out_size: int,
                 scale: Optional[float], kind: str) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size and (scale is None or abs(scale - 1.0) < 1e-12):
        return x
    idx, w = _axis_taps(in_size, out_size, scale, kind, x.device)
    taps = torch.index_select(x, axis, idx.reshape(-1))
    taps = taps.reshape(x.shape[:axis] + (out_size, idx.shape[1])
                        + x.shape[axis + 1:])
    wshape = [1] * taps.dim()
    wshape[axis] = out_size
    wshape[axis + 1] = idx.shape[1]
    return torch.sum(taps * w.reshape(wshape).to(x.dtype), dim=axis + 1)


def _resize(x: torch.Tensor, out_hw: Sequence[int],
            scale_hw: Optional[Sequence[float]], kind: str, h_axis: int,
            w_axis: int) -> torch.Tensor:
    sh, sw = scale_hw if scale_hw is not None else (None, None)
    dtype = x.dtype
    x = x.to(torch.float32)
    x = _resize_axis(x, h_axis, int(out_hw[0]), sh, kind)
    x = _resize_axis(x, w_axis, int(out_hw[1]), sw, kind)
    return x.to(dtype)


def _axes(x: torch.Tensor, channel_last: bool) -> Tuple[int, int]:
    if channel_last:
        return x.dim() - 3, x.dim() - 2
    return x.dim() - 2, x.dim() - 1


def bicubic_resize(x: torch.Tensor, out_hw: Sequence[int],
                   scale_hw: Optional[Sequence[float]] = None,
                   channel_last: bool = True) -> torch.Tensor:
    """torch ``F.interpolate(mode='bicubic', align_corners=False)`` parity.
    x: (..., H, W, C) if channel_last else (..., H, W)."""
    return _resize(x, out_hw, scale_hw, "cubic", *_axes(x, channel_last))


def bilinear_resize(x: torch.Tensor, out_hw: Sequence[int],
                    scale_hw: Optional[Sequence[float]] = None,
                    channel_last: bool = True) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear', align_corners=False)``
    parity."""
    return _resize(x, out_hw, scale_hw, "linear", *_axes(x, channel_last))


def resize_image(image: torch.Tensor, out_hw: Tuple[int, int]
                 ) -> torch.Tensor:
    """Plain full-image bicubic resize in float32 (the no-crop
    preprocessing of the teacher; ``teachers/prompting.py`` in the JAX
    package)."""
    return bicubic_resize(image.to(torch.float32), out_hw)


def bicubic_sample_at(src: torch.Tensor, out_hw: Sequence[int],
                      px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """``bicubic_resize(src, out_hw)[py, px]`` without materialising the
    resized map: per point, the 4x4 source taps with torch's cubic
    weights, accumulated one tap at a time (an (N, C) working set, where
    the reference upsamples each (ph, pw, C) teacher map to the full
    image, utils/feature_fusion.py:167-172).

    src (ph, pw, C); px, py (N,) integer output pixels in [0, W) x
    [0, H). Returns (N, C) float32."""
    ph, pw = src.shape[0], src.shape[1]
    flat = src.reshape(ph * pw, -1).to(torch.float32)

    def taps(coord, out_size, in_size):
        s = (coord.to(torch.float32) + 0.5) * (in_size / out_size) - 0.5
        i0 = torch.floor(s)
        offs = torch.arange(-1, 3, device=coord.device)
        idx = (i0.to(torch.int64)[:, None] + offs).clamp(0, in_size - 1)
        return idx, _cubic_weights(s - i0)  # (N, 4), (N, 4)

    iy, wy = taps(py, int(out_hw[0]), ph)
    ix, wx = taps(px, int(out_hw[1]), pw)
    out = torch.zeros((px.shape[0], flat.shape[1]), dtype=torch.float32,
                      device=src.device)
    for a in range(4):
        for b in range(4):
            w = (wy[:, a] * wx[:, b])[:, None]
            out += flat[iy[:, a] * pw + ix[:, b]] * w
    return out
