"""Shared MinkUNet pieces: architecture table, init, masked batch norm.

Port of the parts of ``dropclip_tpu/sparse/unet.py`` the brick and pillar
engines use (reference architecture: models/distil/minkunet.py:30-263).
The gather-engine ``MinkUNet`` itself waits for a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn


def _kaiming_fan_out(shape: Sequence[int],
                     generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kaiming-normal, fan_out, relu gain (ME.utils.kaiming_normal_
    analogue, reference models/distil/resnet_base.py:73-77). shape
    (K, Cin, Cout). Draws on the CPU so a seed gives the same weights on
    every device."""
    fan_out = shape[0] * shape[-1]
    std = (2.0 / fan_out) ** 0.5
    return std * torch.randn(tuple(shape), generator=generator, dtype=dtype)


class ConvKernel(nn.Module):
    """A sparse conv holding one (K, Cin, Cout) ``kernel`` parameter."""

    def __init__(self, taps: int, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(taps, cin, cout))


class MaskedBatchNorm(nn.Module):
    """Eval-mode BatchNorm over valid voxels (``unet.py:38-78``).

    Parameters ``scale``/``bias`` and running buffers ``mean``/``var``
    keep the flax names. The arithmetic keeps JAX's order: the f32 stats
    cast to ``x.dtype`` first, then rsqrt, scale, bias and the mask —
    ``torch.nn.BatchNorm*`` cannot stand in, it does not mask padding.
    Training-mode statistics come with the trainer (a later slice).
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = (x - self.mean.to(x.dtype)) * torch.rsqrt(
            self.var.to(x.dtype) + self.eps)
        y = y * self.scale.to(x.dtype) + self.bias.to(x.dtype)
        return y * mask[..., None].to(x.dtype)


def reset_student_parameters(model: nn.Module,
                             generator: Optional[torch.Generator] = None
                             ) -> None:
    """Seeded student init: kaiming fan-out conv kernels (drawn on the CPU
    in module order, so engines that register the same modules in the same
    order draw the same weights), unit BN scale/var, zero BN bias/mean."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ConvKernel):
                mod.kernel.copy_(_kaiming_fan_out(tuple(mod.kernel.shape),
                                                  generator))
            elif isinstance(mod, MaskedBatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)


# name -> (block, LAYERS, PLANES) — reference minkunet.py:197-263
UNET_ARCHS: Dict[str, Tuple[str, Tuple[int, ...], Tuple[int, ...]]] = {
    "MinkUNet14A": ("basic", (1,) * 8, (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet14B": ("basic", (1,) * 8, (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet14C": ("basic", (1,) * 8, (32, 64, 128, 256, 192, 192, 128, 128)),
    "MinkUNet14D": ("basic", (1,) * 8, (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet18A": ("basic", (2,) * 8, (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet18B": ("basic", (2,) * 8, (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet18C": ("basic", (2,) * 8, (32, 64, 128, 256, 192, 192, 128, 128)),
    "MinkUNet18D": ("basic", (2,) * 8, (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet18E": ("basic", (2,) * 8, (96, 192, 384, 768, 384, 192, 96, 96)),
    "MinkUNet34A": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 64)),
    "MinkUNet34B": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 32)),
    "MinkUNet34C": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96)),
    "MinkUNet50": ("bottleneck", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 384, 384, 384, 384)),
    # upstream MinkowskiNet's MinkUNet101 spec and its A-E width variants
    # (the reference's bare MinkUNet50/101 classes are not constructible)
    "MinkUNet101": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96)),
    "MinkUNet101A": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet101B": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet101C": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 192, 192, 128, 128)),
    "MinkUNet101D": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet101E": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (96, 192, 384, 768, 384, 192, 96, 96)),
    # miniature archs for tests/smoke runs
    "tiny": ("basic", (1,) * 8, (4, 4, 8, 8, 8, 8, 4, 4)),
    "tiny_bn": ("bottleneck", (1,) * 8, (4, 4, 8, 8, 8, 8, 4, 4)),
}
