"""Host-side (numpy) sparse quantization, padded to fixed capacity.

Copy of ``dropclip_tpu/data/voxelize_np.py`` (numpy only). Same semantics
as ``ME.utils.sparse_quantize`` with return_index/return_inverse
(reference data/dataset_blender.py:406-414): grid = floor(xyz/voxel), one
representative input row per voxel (minimum original index), point->voxel
inverse map, per-voxel labels with conflicts -> ignore_label. Runs on the
host so the device work starts at already-padded arrays; voxels come out
in ascending packed-key order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class VoxelizedNp(NamedTuple):
    coords: np.ndarray       # (cap, 3) int32
    mask: np.ndarray         # (cap,) bool
    unique_idx: np.ndarray   # (cap,) int32 representative input row
    inverse_map: np.ndarray  # (N,) int32 (-1 invalid/overflow)
    labels: np.ndarray       # (cap,) int32
    num_voxels: int
    overflowed: bool


def sparse_quantize_np(
    xyz: np.ndarray,
    voxel_size: float,
    capacity: int,
    labels: Optional[np.ndarray] = None,
    ignore_label: int = 0,
    bits: int = 10,
) -> VoxelizedNp:
    n = xyz.shape[0]
    grid = np.floor(xyz / voxel_size).astype(np.int64)
    bias = 1 << (bits - 1)
    g = grid + bias
    in_range = np.all((g >= 0) & (g < (1 << bits)), axis=-1)
    keys = (g[:, 0] << (2 * bits)) | (g[:, 1] << bits) | g[:, 2]
    keys = np.where(in_range, keys, np.iinfo(np.int64).max)

    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    valid = skeys != np.iinfo(np.int64).max
    heads = np.empty(n, bool)
    heads[:1] = valid[:1]  # an empty cloud has no head
    heads[1:] = (skeys[1:] != skeys[:-1]) & valid[1:]
    vox_id = np.cumsum(heads) - 1
    num = int(heads.sum())
    overflow = num > capacity

    keep = valid & (vox_id < capacity)
    inverse = np.full(n, -1, np.int32)
    inverse[order[keep]] = vox_id[keep].astype(np.int32)

    kept = min(num, capacity)
    unique_idx = np.zeros(capacity, np.int32)
    head_rows = order[heads & keep]
    unique_idx[:kept] = head_rows.astype(np.int32)
    mask = np.zeros(capacity, bool)
    mask[:kept] = True
    coords = np.zeros((capacity, 3), np.int32)
    coords[:kept] = grid[head_rows].astype(np.int32)

    vlabels = np.zeros(capacity, np.int32)
    if labels is not None:
        lab = np.asarray(labels).astype(np.int64)
        slab = lab[order]
        sel = keep
        ids = vox_id[sel]
        lmin = np.full(capacity, np.iinfo(np.int64).max, np.int64)
        lmax = np.full(capacity, np.iinfo(np.int64).min, np.int64)
        np.minimum.at(lmin, ids, slab[sel])
        np.maximum.at(lmax, ids, slab[sel])
        agree = lmin == lmax
        vlabels[:kept] = np.where(agree, lmin, ignore_label)[:kept].astype(np.int32)
        vlabels[~mask] = 0

    return VoxelizedNp(coords=coords, mask=mask, unique_idx=unique_idx,
                       inverse_map=inverse, labels=vlabels,
                       num_voxels=kept, overflowed=overflow)
