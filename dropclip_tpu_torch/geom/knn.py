"""Nearest-neighbour correspondence queries.

Port of ``dropclip_tpu/geom/knn.py``, two implementations of the
reference's KD-tree matching (reference utils/geometry.py:390-401
``find_closest_indices``):
- on the host, scipy's ``cKDTree`` (the offline ingest paths);
- on the caller's device, a brute-force 1-NN in chunks of targets
  (torch ops: one matmul and an argmin per chunk).
"""

from __future__ import annotations

import numpy as np
import torch


def find_closest_indices(source: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """For every row of ``targets``, the index of its nearest ``source`` row
    (reference geometry.py:390-401 semantics)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(source))
    _, idx = tree.query(np.asarray(targets), k=1)
    return np.asarray(idx, np.int64)


def nearest_neighbor_device(source, targets, chunk: int = 2048
                            ) -> torch.Tensor:
    """1-NN on the device of ``source`` (a tensor; arrays go to the CPU):
    (N, 3) source, (M, 3) targets -> (M,) int32 indices into source.

    ||t - s||^2 = |t|^2 - 2 t.s + |s|^2: |t|^2 is the same for every
    candidate, so the argmin takes s2 - 2 t.s, one matmul per chunk."""
    source = torch.as_tensor(source, dtype=torch.float32)
    targets = torch.as_tensor(targets, dtype=torch.float32).to(source.device)
    s2 = (source * source).sum(1)
    out = [torch.argmin(s2[None, :] - 2.0 * (t @ source.T), dim=1)
           for t in targets.split(chunk)]
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=source.device)
    return torch.cat(out).to(torch.int32)
