"""The grounding pipeline's host voxelization and paired-softmax masks in
plain NumPy and PyTorch (reference models/similarity.py).

A cloud is centred on its mean (float32), quantized to ``floor(xyz /
voxel)``; each occupied voxel, in (x, y, z) lexicographic order, takes
the inputs (centred xyz, rgb) of its first point. A query's score at a
voxel is the softmax over [pos repeated once per negative, negatives] of
``cos / T`` at its first column (0 at a voxel whose features are all
zero), min-max normalized over the scene's voxels; the mask is the
normalized score above the threshold."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def voxelize(xyz: np.ndarray, rgb: np.ndarray, voxel: float
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(coords (V, 3) int, inputs (V, 6) float32, voxel of each point)."""
    xyz = np.asarray(xyz, np.float32)
    centred = xyz - xyz.mean(axis=0)
    grid = np.floor(centred / np.float32(voxel)).astype(np.int64)
    coords, first, inv = np.unique(grid, axis=0, return_index=True,
                                   return_inverse=True)
    feats = np.concatenate([centred[first], rgb[first]], -1)
    return coords, feats.astype(np.float32), inv.reshape(-1)


def paired_scores(feats: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                  temp: float = 0.1) -> torch.Tensor:
    """(V, C) features, (Q, C) and (K, C) unit text features -> (Q, V)
    min-max normalized paired scores."""
    vis = feats.float() / feats.float().norm(dim=-1, keepdim=True)
    p = pos.float() @ vis.T                      # (Q, V)
    n = (vis @ neg.float().T)[None]              # (1, V, K)
    logits = torch.cat([p[..., None].expand(-1, -1, neg.shape[0]),
                        n.expand(p.shape[0], -1, -1)], -1) / temp
    s = torch.nan_to_num(torch.softmax(logits, -1)[..., 0])  # zero rows
    lo, hi = s.amin(-1, keepdim=True), s.amax(-1, keepdim=True)
    return (s - lo) / (hi - lo)
