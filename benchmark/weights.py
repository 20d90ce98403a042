"""Weights made by the benchmark from a seed, handed to the program and
to the reference alike: one draw of a generator on the target device,
split into the leaves in the order given, each scaled by its init."""

from __future__ import annotations

from typing import Callable, Dict

import torch


def draw(shapes: Dict[str, tuple], init: Callable[[str, tuple], tuple],
         seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor}: ``init(name, shape)`` gives (std, mean); a leaf of
    std 0 is its mean alone. One normal draw for all leaves."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        std, mean = init(name, shape)
        out[name] = (flat[at:at + n].view(shape) * std + mean).to(dtype)
        at += n
    return out


def student_init(name: str, shape: tuple) -> tuple:
    """Kaiming normal (fan out, relu gain) conv kernels, unit batch-norm
    scales and variances, zero biases and means (MinkowskiEngine's)."""
    if name.endswith(".kernel"):
        return (2.0 / (shape[0] * shape[-1])) ** 0.5, 0.0
    if name.endswith((".scale", ".var")):
        return 0.0, 1.0
    return 0.0, 0.0
