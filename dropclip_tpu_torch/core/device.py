"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the card; raises without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "dropclip_tpu_torch runs on a CUDA card and none is visible; "
            "pass device='cpu' to run the plain PyTorch versions instead")
    return torch.device("cuda")
