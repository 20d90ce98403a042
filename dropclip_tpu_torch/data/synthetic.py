"""Synthetic tabletop voxel scenes for smoke runs and benchmarks.

Copy of ``make_tabletop_coords`` from ``dropclip_tpu/data/synthetic.py``
(same generator, same numbers from the same ``RandomState``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_tabletop_coords(rng: np.random.RandomState, batch: int,
                         capacity: int, n_occ: int = 6000, ext: int = 40,
                         n_blobs: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """Padded voxel coords with tabletop brick statistics.

    A z-thin table plane (z in {0, 1}) plus ``n_blobs`` object shells —
    the occupancy pattern that drives brick-engine cost on real MV-TOD
    clouds. Returns (coords (B, capacity, 3) int32, mask (B, capacity)
    bool), so synthetic runs exercise realistic brick occupancy, not
    uniform noise.
    """
    coords = np.zeros((batch, capacity, 3), np.int32)
    mask = np.zeros((batch, capacity), bool)
    for b in range(batch):
        xy = rng.randint(-ext, ext, size=(3 * n_occ, 2))
        z = rng.randint(0, 2, size=(3 * n_occ, 1))
        parts = [np.concatenate([xy, z], axis=1)]
        if ext > 6:  # blob centers need randint(-ext+6, ext-6) nonempty
            for _ in range(n_blobs):
                c = rng.randint(-ext + 6, ext - 6, size=3)
                c[2] = rng.randint(2, 8)
                th = rng.randn(n_occ // 4, 3)
                th /= np.linalg.norm(th, axis=1, keepdims=True)
                parts.append((c + th * rng.randint(3, 6)).astype(int))
        pts = np.concatenate(parts).astype(np.int32)
        uniq = np.unique(pts, axis=0)
        rng.shuffle(uniq)
        uniq = uniq[: min(n_occ, capacity)]
        coords[b, : len(uniq)] = uniq
        mask[b, : len(uniq)] = True
    return coords, mask
