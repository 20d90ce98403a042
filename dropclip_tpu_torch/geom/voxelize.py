"""Fixed-capacity voxelization on the device: sparse quantization and
voxel-average downsampling with a majority label vote.

Port of ``dropclip_tpu/geom/voxelize.py``. Voxel identity is a packed
int32 key (``ravel_grid_coords``, ``unravel_key``); a stable sort of the
keys gives each point its voxel's rank (run heads + cumsum).

- ``sparse_quantize`` replaces ``ME.utils.sparse_quantize`` (reference
  data/dataset_blender.py:406-414): one representative point per voxel
  (the minimum original index), the inverse map point -> voxel (-1 for
  invalid or dropped points), per-voxel labels with ``ignore_label`` on
  conflict, the voxel count and an overflow flag. Torch ops only, with
  no read back to the host, over any leading batch axes.
- ``voxel_downsample`` replaces Open3D's ``voxel_down_sample_and_trace``
  + Counter vote (reference utils/geometry.py:186-201): one (N, 7 +
  labels) payload of [count, xyz, colour, one-hot label] is summed per
  voxel with ``index_add_``, in chunks of 4M points so the payload's
  memory stays bounded.

Voxels come out in ascending key order, padded to ``capacity`` with a
mask. On the card ``voxel_downsample``'s float sums run with atomics in
no fixed order, so voxel means differ from the CPU's in the last bits;
counts, ranks, labels and ``dropped`` are exact, as is every field of
``sparse_quantize``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

INVALID_KEY = 2 ** 31 - 1  # int32 max: invalid points sort last
CHUNK = 4 * 1024 * 1024


def ravel_grid_coords(grid: torch.Tensor, bits: int = 10,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack signed (..., 3) int grid coords into sortable non-negative
    int32 keys; rows out of the 2**bits range or not ``valid`` map to
    INVALID_KEY."""
    assert 3 * bits <= 31, f"3*{bits} bits do not fit an int32 key"
    bias = 1 << (bits - 1)
    g = grid.to(torch.int32) + bias
    key = (g[..., 0] << (2 * bits)) | (g[..., 1] << bits) | g[..., 2]
    in_range = ((g >= 0) & (g < (1 << bits))).all(dim=-1)
    if valid is not None:
        in_range = in_range & valid
    return torch.where(in_range, key, torch.full_like(key, INVALID_KEY))


def unravel_key(key: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Inverse of ``ravel_grid_coords`` for valid keys: (...) -> (..., 3)."""
    bias = 1 << (bits - 1)
    low = (1 << bits) - 1
    return torch.stack([(key >> (2 * bits)) & low, (key >> bits) & low,
                        key & low], dim=-1).to(torch.int32) - bias


class Voxelized(NamedTuple):
    """Fixed-capacity voxelization (all tensors padded to V = capacity,
    with the leading batch axes of the input).

    coords:      (..., V, 3) int32 voxel grid coords, ascending key order.
    mask:        (..., V) bool occupancy.
    unique_idx:  (..., V) int32 input point that represents each voxel
                 (the minimum original index).
    inverse_map: (..., N) int32 voxel of every input point (-1: invalid
                 or past capacity).
    labels:      (..., V) int32 per-voxel label, ``ignore_label`` where
                 the voxel's points disagree; zeros without labels.
    num_voxels:  (...) int32 voxels kept (<= V).
    overflowed:  (...) bool, True where unique voxels exceeded capacity
                 (the extra voxels were dropped).
    """

    coords: torch.Tensor
    mask: torch.Tensor
    unique_idx: torch.Tensor
    inverse_map: torch.Tensor
    labels: torch.Tensor
    num_voxels: torch.Tensor
    overflowed: torch.Tensor


def sparse_quantize(xyz: torch.Tensor, voxel_size: float, capacity: int,
                    valid: Optional[torch.Tensor] = None,
                    labels: Optional[torch.Tensor] = None,
                    ignore_label: int = 0, bits: int = 10) -> Voxelized:
    """Quantize (..., N, 3) float points to a fixed-capacity voxel set:
    grid = floor(xyz / voxel_size), one representative per voxel, the
    inverse map, per-voxel labels with conflict -> ``ignore_label``
    (``ME.utils.sparse_quantize(..., return_index=True,
    return_inverse=True)``). Writes past ``capacity`` go to a slot
    ``capacity`` that is cut off, as the JAX package's ``mode="drop"``
    and its ``capacity + 1`` segments do."""
    dev = xyz.device
    if valid is None:
        valid = torch.ones(xyz.shape[:-1], dtype=torch.bool, device=dev)
    grid = torch.floor(xyz / voxel_size).to(torch.int32)
    keys = ravel_grid_coords(grid, bits=bits, valid=valid)
    sorted_keys, order = torch.sort(keys, dim=-1, stable=True)
    sorted_valid = sorted_keys != INVALID_KEY
    heads = sorted_valid.clone()
    heads[..., 1:] &= sorted_keys[..., 1:] != sorted_keys[..., :-1]
    vid = torch.cumsum(heads, dim=-1, dtype=torch.int32) - 1
    num_voxels = heads.sum(dim=-1, dtype=torch.int32)
    overflowed = num_voxels > capacity
    kept = num_voxels.clamp(max=capacity)
    keep = sorted_valid & (vid < capacity)

    # the inverse map back in the input order
    inv_sorted = torch.where(keep, vid, torch.full_like(vid, -1))
    inverse_map = torch.empty_like(inv_sorted).scatter_(-1, order,
                                                        inv_sorted)
    # the representative: each voxel's run head, the minimum original
    # index because the sort is stable
    slot = torch.where(heads & keep, vid, torch.full_like(vid, capacity))
    unique_idx = torch.zeros((*xyz.shape[:-2], capacity + 1),
                             dtype=torch.int32, device=dev).scatter_(
        -1, slot.to(torch.int64), order.to(torch.int32))[..., :capacity]
    vmask = torch.arange(capacity, device=dev) < kept[..., None]
    rep = torch.gather(grid, -2, unique_idx.to(torch.int64)[..., None]
                       .expand(*unique_idx.shape, 3))
    coords = torch.where(vmask[..., None], rep, torch.zeros_like(rep))

    vlabels = torch.zeros(vmask.shape, dtype=torch.int32, device=dev)
    if labels is not None:
        seg = torch.where(keep, vid, torch.full_like(vid, capacity)).to(
            torch.int64)
        lab_sorted = torch.gather(labels.to(torch.int32).expand(
            xyz.shape[:-1]), -1, order)
        buf = torch.zeros((*xyz.shape[:-2], capacity + 1),
                          dtype=torch.int32, device=dev)
        lmin = buf.scatter_reduce(-1, seg, lab_sorted, "amin",
                                  include_self=False)[..., :capacity]
        lmax = buf.scatter_reduce(-1, seg, lab_sorted, "amax",
                                  include_self=False)[..., :capacity]
        same = torch.where(lmin == lmax, lmin,
                           torch.full_like(lmin, ignore_label))
        vlabels = torch.where(vmask, same, vlabels)
    return Voxelized(coords=coords, mask=vmask, unique_idx=unique_idx,
                     inverse_map=inverse_map, labels=vlabels,
                     num_voxels=kept, overflowed=overflowed)


def voxel_downsample(xyz: torch.Tensor, colors: torch.Tensor,
                     labels: torch.Tensor, voxel_size: float, capacity: int,
                     num_label_classes: int,
                     valid: Optional[torch.Tensor] = None, bits: int = 10
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    """(N, 3) points, (N, 3) colours, (N,) labels -> (xyz_v (cap, 3),
    colors_v (cap, 3), labels_v (cap,) int32, mask (cap,), dropped ()
    int32: valid points lost to the grid extent or to capacity)."""
    n = xyz.shape[0]
    dev = xyz.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    grid = torch.floor(xyz / voxel_size).to(torch.int32)
    keys = ravel_grid_coords(grid, bits=bits, valid=valid)
    sk, order = torch.sort(keys, stable=True)
    svalid = sk != INVALID_KEY
    heads = svalid.clone()
    heads[1:] &= sk[1:] != sk[:-1]
    rank = torch.cumsum(heads, dim=0, dtype=torch.int64) - 1
    n_vox = torch.clamp(rank[-1] + 1, max=capacity) if n else rank.new_zeros(())
    row_sorted = torch.where(svalid & (rank < capacity), rank,
                             torch.full_like(rank, capacity))
    # voxel row per point in the original order (capacity = dropped)
    row = torch.empty_like(row_sorted)
    row[order] = row_sorted
    del sk, order, svalid, heads, rank, row_sorted
    vmask = torch.arange(capacity, device=dev) < n_vox
    dropped = (valid & (row >= capacity)).sum(dtype=torch.int32)

    lab = labels.to(torch.int64).clamp(0, num_label_classes - 1)
    width = 7 + num_label_classes
    acc = torch.zeros((capacity + 1, width), dtype=torch.float32, device=dev)
    classes = torch.arange(num_label_classes, device=dev)
    for i in range(0, n, CHUNK):
        seg = row[i: i + CHUNK]
        payload = torch.cat([
            torch.ones((seg.shape[0], 1), dtype=torch.float32, device=dev),
            xyz[i: i + CHUNK].to(torch.float32),
            colors[i: i + CHUNK].to(torch.float32),
            (lab[i: i + CHUNK, None] == classes).to(torch.float32)], dim=1)
        payload *= (seg < capacity).to(torch.float32)[:, None]
        acc.index_add_(0, seg, payload)
    acc = acc[:capacity]
    cnt = acc[:, 0].clamp_min(1.0)
    xyz_v = acc[:, 1:4] / cnt[:, None]
    col_v = acc[:, 4:7] / cnt[:, None]
    labels_v = torch.argmax(acc[:, 7:], dim=-1).to(torch.int32)
    m3 = vmask[:, None]
    return (torch.where(m3, xyz_v, torch.zeros_like(xyz_v)),
            torch.where(m3, col_v, torch.zeros_like(col_v)),
            torch.where(vmask, labels_v, torch.zeros_like(labels_v)),
            vmask, dropped)
