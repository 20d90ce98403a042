"""Weight bridge: JAX (flax) parameter trees -> the port's state dicts.

Inputs are nested dicts of numpy arrays (``jax.tree_util.tree_map(
np.asarray, variables)`` on the JAX side, or any checkpoint reader that
yields the same tree); nothing here imports jax.

- Student (``MinkUNetBricks`` or ``MinkUNetPillars``: one flax tree for
  both engines, as in the JAX package): ``params`` + ``batch_stats``
  flatten one to one onto the module tree — sparse kernels stay
  (K, Cin, Cout) in ``bricks._NBR_OFFSETS`` order (the pillar engine
  reshapes them to (xy-dirs, dz, Cin, Cout) at use), BN maps
  ``scale``/``bias`` (params) and ``mean``/``var`` (batch stats).
- CLIP text tower (``CLIPTextTransformer``): the ``params["text"]`` tree;
  ``nn.Dense`` kernels are (in, out) and transpose to ``Linear.weight``,
  ``block_i`` becomes ``blocks.i``, the embedding table, positional
  embedding and text projection carry over as they are.
- Whole CLIP (``CLIP``): ``visual`` maps like the text tower, and the
  (p, p, 3, width) HWIO patch-conv kernel becomes the (width, p*p*3)
  weight of the linear layer over (kh, kw, c)-ordered patches;
  ``logit_scale`` carries over.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def student_state_dict(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """flax student variables (any engine) -> the state dict of
    ``MinkUNetBricks`` and of ``MinkUNetPillars`` (the same keys)."""
    sd = {k: _tensor(v) for k, v in _flatten(params).items()}
    sd.update({k: _tensor(v) for k, v in _flatten(batch_stats).items()})
    return sd


def clip_text_state_dict(text_params: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """flax ``CLIPTextTransformer`` params (``params["text"]``) ->
    ``CLIPTextTransformer.state_dict()`` (float32; ``load_state_dict``
    casts to each parameter's dtype)."""
    return _tower_state_dict(text_params)


def clip_vision_state_dict(visual_params: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """flax ``CLIPVisionTransformer`` params (``params["visual"]``) ->
    ``CLIPVisionTransformer.state_dict()``."""
    return _tower_state_dict(visual_params)


def _tower_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd = {}
    for key, val in _flatten(params).items():
        parts = key.split(".")
        if parts[0].startswith("block_"):
            parts = ["blocks", parts[0][len("block_"):]] + parts[1:]
        leaf = parts[-1]
        t = _tensor(val)
        if leaf == "kernel" and t.dim() == 4:  # patch conv, HWIO
            parts[-1], t = "weight", t.reshape(-1, t.shape[-1]).T.contiguous()
        elif leaf == "kernel":  # nn.Dense (in, out) -> Linear.weight
            parts[-1], t = "weight", t.T.contiguous()
        elif leaf == "embedding":
            parts[-1] = "weight"
        sd[".".join(parts)] = t
    return sd


def clip_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``CLIP`` params (the whole ``params`` tree: ``visual``,
    ``text``, ``logit_scale``) -> ``CLIP.state_dict()`` (ViT towers)."""
    sd = {f"visual.{k}": v for k, v in
          clip_vision_state_dict(params["visual"]).items()}
    sd.update({f"text.{k}": v for k, v in
               clip_text_state_dict(params["text"]).items()})
    sd["logit_scale"] = _tensor(params["logit_scale"]).reshape(())
    return sd
