"""Weight bridge: JAX (flax) parameter trees -> the port's state dicts.

Inputs are nested dicts of numpy arrays (``jax.tree_util.tree_map(
np.asarray, variables)`` on the JAX side, or any checkpoint reader that
yields the same tree); nothing here imports jax.

- Student (``MinkUNetBricks``): ``params`` + ``batch_stats`` flatten one
  to one onto the module tree — sparse kernels stay (K, Cin, Cout) in
  ``bricks._NBR_OFFSETS`` order, BN maps ``scale``/``bias`` (params) and
  ``mean``/``var`` (batch stats).
- CLIP text tower (``CLIPTextTransformer``): the ``params["text"]`` tree;
  ``nn.Dense`` kernels are (in, out) and transpose to ``Linear.weight``,
  ``block_i`` becomes ``blocks.i``, the embedding table, positional
  embedding and text projection carry over as they are.
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
    """flax MinkUNetBricks variables -> ``MinkUNetBricks.state_dict()``."""
    sd = {k: _tensor(v) for k, v in _flatten(params).items()}
    sd.update({k: _tensor(v) for k, v in _flatten(batch_stats).items()})
    return sd


def clip_text_state_dict(text_params: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """flax ``CLIPTextTransformer`` params (``params["text"]``) ->
    ``CLIPTextTransformer.state_dict()`` (float32; ``load_state_dict``
    casts to each parameter's dtype)."""
    sd = {}
    for key, val in _flatten(text_params).items():
        parts = key.split(".")
        if parts[0].startswith("block_"):
            parts = ["blocks", parts[0][len("block_"):]] + parts[1:]
        leaf = parts[-1]
        t = _tensor(val)
        if leaf == "kernel":  # nn.Dense (in, out) -> Linear.weight (out, in)
            parts[-1], t = "weight", t.T.contiguous()
        elif leaf == "embedding":
            parts[-1] = "weight"
        sd[".".join(parts)] = t
    return sd
