"""Checkpoint and resume with the reference's policy, on ``torch.save``.

Port of ``dropclip_tpu/core/checkpoint.py``. Reference policy
(tools/train_distil.py:195-216, 255-271): save the training state each
epoch as ``last_model`` and copy it to ``best_sim_loss_model`` when the
validation similarity loss improves; resume restores everything. The
schedule is a function of the step and there is no loss scaler, so the
payload is {step, model (parameters and BN running stats), opt_state,
epoch, best_val}. The JAX package's orbax directories are not read: the
card's machine has no orbax.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
from torch import nn

LAST_NAME = "last_model"
BEST_NAME = "best_sim_loss_model"


def save_checkpoint(save_dir: str, payload: Dict[str, Any],
                    name: str = LAST_NAME, best: bool = False) -> None:
    """``torch.save`` of ``payload`` as ``save_dir/name.pt``, written to a
    temporary name and renamed into place; with ``best`` also as
    ``save_dir/best_sim_loss_model.pt``."""
    save_dir = os.path.abspath(save_dir)
    os.makedirs(save_dir, exist_ok=True)
    for n in (name, BEST_NAME) if best else (name,):
        path = os.path.join(save_dir, f"{n}.pt")
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)


def restore_checkpoint(save_dir: str, name: str = LAST_NAME,
                       map_location: Any = "cpu") -> Optional[Dict]:
    """The payload saved as ``save_dir/name.pt``; None if there is none.
    Loaded with ``weights_only``: tensors and plain containers only."""
    path = os.path.join(os.path.abspath(save_dir), f"{name}.pt")
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location=map_location, weights_only=True)


def load_model(model: nn.Module, save_dir: str, name: str = LAST_NAME,
               map_location: Any = "cpu") -> Dict:
    """Load the student weights of ``save_dir/name.pt`` into ``model``;
    returns the payload. Raises FileNotFoundError when there is none."""
    restored = restore_checkpoint(save_dir, name, map_location)
    if restored is None:
        raise FileNotFoundError(f"no {name}.pt in {save_dir}")
    model.load_state_dict(restored["model"])
    return restored
