"""Voxel-average downsampling with a majority label vote, on the device.

Port of ``ravel_grid_coords`` and ``voxel_downsample`` from
``dropclip_tpu/geom/voxelize.py`` (replacing Open3D's
``voxel_down_sample_and_trace`` + Counter vote, reference
utils/geometry.py:186-201). Voxel identity is a packed int32 key; a
stable sort of the keys gives each point its voxel's rank (run heads +
cumsum), and one (N, 7 + labels) payload of [count, xyz, colour, one-hot
label] is summed per voxel with ``index_add_``, in chunks of 4M points so
the payload's memory stays bounded. Voxels come out in ascending key
order, padded to ``capacity`` with a mask.

On the card the float sums run with atomics in no fixed order, so voxel
means differ from the CPU's in the last bits; counts, ranks, labels and
``dropped`` are exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
