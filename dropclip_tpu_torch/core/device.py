"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import os

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


def env_flag(name: str, default: bool = False) -> bool:
    """A boolean switch from the environment: unset or empty gives
    ``default``; "0", "false", "no" and "off" give False."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "false", "no", "off")
