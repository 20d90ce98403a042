"""Object-centric visual prompts for the CLIP teacher, on the device.

Port of ``dropclip_tpu/teachers/prompting.py`` (reference
models/features/extractor.py:306-367 ``make_prompt``, utils/image.py:45-86
box helpers): bbox from mask, multi-level expansion, crop, padding to the
image's aspect ratio with a background colour, bicubic resize to the
model input and CLIP normalisation, as tensor arithmetic and gathers.
The crop -> pad -> resize composition is one bicubic sampling into the
fixed output grid, with taps outside the crop reading the background
colour (torch/OpenCV cubic kernel, a = -0.75, no antialiasing).

Where the JAX package maps over objects one at a time (``lax.map``), the
port batches them: every function takes a leading batch axis of objects
(or of (view, object) pairs, each with its own image), so one call builds
a whole chunk of prompts. Values are the JAX ones object by object.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.resize import _cubic_weights, resize_image

# torchvision CLIP normalisation constants (extractor.py:66-69)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

PROMPT_KINDS = ("crop", "crop-mask", "mask-blur", "mask-gray", "mask-out")


def mask_to_box(mask: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> (..., 4) int32 (x1, y1, x2, y2), x2/y2
    exclusive. Empty mask -> (0, 0, 1, 1)."""
    h, w = mask.shape[-2:]
    any_col = mask.any(dim=-2)  # (..., W)
    any_row = mask.any(dim=-1)  # (..., H)
    xs = torch.arange(w, device=mask.device)
    ys = torch.arange(h, device=mask.device)
    x1 = torch.where(any_col, xs, w).amin(-1)
    x2 = torch.where(any_col, xs, -1).amax(-1) + 1
    y1 = torch.where(any_row, ys, h).amin(-1)
    y2 = torch.where(any_row, ys, -1).amax(-1) + 1
    box = torch.stack([x1, y1, x2, y2], dim=-1)
    empty = ~any_col.any(-1)
    fallback = torch.tensor([0, 0, 1, 1], device=mask.device)
    return torch.where(empty[..., None], fallback, box).to(torch.int32)


def expand_box(box: torch.Tensor, level: int, expansion_ratio: float,
               hw: Tuple[int, int]) -> torch.Tensor:
    """Multi-level box expansion (reference utils/image.py:77-86)."""
    if level == 0:
        return box
    x1, y1, x2, y2 = box.unbind(-1)
    ratio = torch.tensor(expansion_ratio, dtype=torch.float32)
    x_exp = ((x2 - x1).abs().float() * ratio).to(torch.int32) * level
    y_exp = ((y2 - y1).abs().float() * ratio).to(torch.int32) * level
    return torch.stack([(x1 - x_exp).clamp_min(0), (y1 - y_exp).clamp_min(0),
                        (x2 + x_exp).clamp_max(hw[1]),
                        (y2 + y_exp).clamp_max(hw[0])], dim=-1)


def background_color(image: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """Black if the object is closer to white, else white: (..., 3)
    floats in 0..255 for (..., H, W, 3) images and (..., H, W) masks."""
    w = mask.to(torch.float32)[..., None]
    mean = ((image.to(torch.float32) * w).sum(dim=(-3, -2))
            / w.sum(dim=(-3, -2)).clamp_min(1.0))
    to_white = torch.linalg.vector_norm(mean - 255.0, dim=-1)
    to_black = torch.linalg.vector_norm(mean, dim=-1)
    white = torch.full_like(mean, 255.0)
    return torch.where((to_white < to_black)[..., None],
                       torch.zeros_like(mean), white)


def crop_pad_resize(image: torch.Tensor, box: torch.Tensor,
                    bg: torch.Tensor, out_hw: Tuple[int, int],
                    target_ratio: float) -> torch.Tensor:
    """crop box -> pad to the target W/H ratio with bg -> bicubic resize,
    as one separable sampling. image (N, H, W, 3) float 0..255, box (N, 4),
    bg (N, 3) -> (N, oh, ow, 3)."""
    n, H, W = image.shape[:3]
    oh, ow = out_hw
    dev = image.device
    x1, y1 = box[:, 0].float(), box[:, 1].float()
    w = (box[:, 2] - box[:, 0]).float()
    h = (box[:, 3] - box[:, 1]).float()

    # padded-canvas size (integer semantics of add_borders_to_image)
    ratio = w / h
    ph = torch.where(ratio > target_ratio, torch.floor(w / target_ratio), h)
    pw = torch.where(ratio < target_ratio, torch.floor(h * target_ratio), w)
    pad_top = torch.floor((ph - h) / 2.0)
    pad_left = torch.floor((pw - w) / 2.0)

    # output pixel -> padded-canvas source coordinate (torch half-pixel)
    ys = ((torch.arange(oh, dtype=torch.float32, device=dev) + 0.5)
          * (ph / oh)[:, None] - 0.5)  # (N, oh)
    xs = ((torch.arange(ow, dtype=torch.float32, device=dev) + 0.5)
          * (pw / ow)[:, None] - 0.5)  # (N, ow)
    iy0, ix0 = torch.floor(ys), torch.floor(xs)
    wy = _cubic_weights(ys - iy0)  # (N, oh, 4)
    wx = _cubic_weights(xs - ix0)  # (N, ow, 4)
    taps = torch.arange(-1, 3, dtype=torch.float32, device=dev)
    ty = torch.minimum((iy0[..., None] + taps).clamp_min(0),
                       (ph - 1)[:, None, None])  # (N, oh, 4)
    tx = torch.minimum((ix0[..., None] + taps).clamp_min(0),
                       (pw - 1)[:, None, None])  # (N, ow, 4)

    # padded space -> crop content: rows [pad_top, pad_top + h), else bg
    cy = ty - pad_top[:, None, None]
    cx = tx - pad_left[:, None, None]
    in_y = (cy >= 0) & (cy < h[:, None, None])
    in_x = (cx >= 0) & (cx < w[:, None, None])
    gy = (cy + y1[:, None, None]).clamp(0, H - 1).to(torch.int64)
    gx = (cx + x1[:, None, None]).clamp(0, W - 1).to(torch.int64)
    bg4 = bg.to(torch.float32)[:, None, None, None, :]

    img = image.to(torch.float32)
    rows = torch.gather(img, 1, gy.reshape(n, oh * 4, 1, 1).expand(
        n, oh * 4, W, 3)).reshape(n, oh, 4, W, 3)
    rows = torch.where(in_y[..., None, None], rows, bg4)
    r = torch.einsum("nyawc,nya->nywc", rows, wy)  # (N, oh, W, 3)

    cols = torch.gather(r, 2, gx.reshape(n, 1, ow * 4, 1).expand(
        n, oh, ow * 4, 3)).reshape(n, oh, ow, 4, 3)
    cols = torch.where(in_x[:, None, :, :, None], cols, bg4)
    return torch.einsum("noxbc,nxb->noxc", cols, wx)


def normalize(image01: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD
              ) -> torch.Tensor:
    """(..., 3) in 0..1 -> CLIP-normalised."""
    m = torch.tensor(mean, dtype=torch.float32, device=image01.device)
    s = torch.tensor(std, dtype=torch.float32, device=image01.device)
    return (image01 - m) / s


def _conv1d_reflect(x: torch.Tensor, kernel: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """Correlate along ``axis`` with an odd kernel, REFLECT_101 border
    (cv2 BORDER_REFLECT_101 == numpy 'reflect'), as shift-and-add."""
    r = kernel.shape[0] // 2
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).abs()
    idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
    xp = torch.index_select(x, axis, idx)
    out = torch.zeros_like(x)
    for i in range(kernel.shape[0]):
        out = out + kernel[i] * xp.narrow(axis, i, n)
    return out


def gaussian_blur(image: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.GaussianBlur(image, (k, k), 0) parity on (..., H, W, C): sigma
    from ksize (0.3*((k-1)*0.5 - 1) + 0.8), separable, REFLECT_101."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = ksize // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=image.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    img = image.to(torch.float32)
    return _conv1d_reflect(_conv1d_reflect(img, k, img.dim() - 3), k,
                           img.dim() - 2)


def rgb_to_gray3(image: torch.Tensor) -> torch.Tensor:
    """cv2 RGB2GRAY weights, replicated to 3 channels."""
    g = 0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]
    return torch.stack([g, g, g], dim=-1)


def num_prompts(kinds: Sequence[str], crop_num_levels: int) -> int:
    return sum(crop_num_levels if k in ("crop", "crop-mask") else 1
               for k in kinds)


def build_prompts(image: torch.Tensor, masks: torch.Tensor,
                  kinds: Sequence[str] = ("crop-mask",),
                  crop_num_levels: int = 1,
                  crop_expansion_ratio: float = 0.15, blur_kernel: int = 41,
                  out_hw: Tuple[int, int] = (336, 448), mean=CLIP_MEAN,
                  std=CLIP_STD) -> torch.Tensor:
    """Image (H, W, 3) uint8/float 0..255 with (K, H, W) bool instance
    masks, or (K, H, W, 3) images paired one to one with the masks ->
    (K, L, oh, ow, 3) normalised prompt batch."""
    for kind in kinds:
        if kind not in PROMPT_KINDS:
            raise ValueError(f"unknown visual prompt {kind!r}")
    k = masks.shape[0]
    H, W = masks.shape[-2:]
    target_ratio = float(W) / float(H)
    img = image.to(torch.float32)
    shared = img.dim() == 3
    imgs = img.expand(k, H, W, 3) if shared else img
    blurred = gray = None
    if "mask-blur" in kinds:
        blurred = gaussian_blur(img, blur_kernel)
    if "mask-gray" in kinds:
        gray = rgb_to_gray3(img)

    bg = background_color(imgs, masks)  # (K, 3)
    box0 = mask_to_box(masks)
    m3 = masks[..., None]
    prompts = []
    for kind in kinds:
        if kind in ("crop", "crop-mask"):
            src = imgs if kind == "crop" else torch.where(
                m3, imgs, bg[:, None, None, :])
            for level in range(crop_num_levels):
                b = expand_box(box0, level, crop_expansion_ratio, (H, W))
                prompts.append(crop_pad_resize(src, b, bg, out_hw,
                                               target_ratio))
        else:
            other = {"mask-blur": blurred, "mask-gray": gray}.get(kind)
            other = bg[:, None, None, :] if other is None else other
            prompts.append(resize_image(torch.where(m3, imgs, other),
                                        out_hw))
    batch = torch.stack(prompts, dim=1)  # (K, L, oh, ow, 3), 0..255
    return normalize(batch / 255.0, mean, std)

