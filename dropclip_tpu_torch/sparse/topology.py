"""Sparse-voxel topology of the gather engine, built on the device.

Port of ``dropclip_tpu/sparse/topology.py`` (MinkowskiEngine's coordinate
manager and kernel maps, behind every ``ME.MinkowskiConvolution`` of
reference models/distil/minkunet.py:49-126):

- every pyramid level is a fixed-capacity, mask-padded voxel set in
  ascending packed-key order (``geom.voxelize.ravel_grid_coords``, 10
  bits an axis);
- a neighbour is found by ``torch.searchsorted`` into the level's sorted
  keys; kernel maps are dense (K, M) index tensors whose misses point at
  row M (the zero row of ``sparse.ops``);
- stride-2 levels halve coordinates with floor semantics (arithmetic
  shift), ME's ``unique(floor(c / 2))``, sorted again before the dedup
  (halving does not keep key order); the transposed convs reuse the
  encoder's sets, as ME's coordinate keys make the skip concats line up
  (minkunet.py:128-195).

Level capacities default to ``max(m >> l, min(m, 64))``. The tables equal
the JAX builder's element for element. Unlike it, the port counts what
it loses (``UNetTopology.dropped``, per scene and level): input voxels
outside the keys' 2**10 range at level 0, and coarse voxels past a
level's capacity (the JAX builder masks both away and reports nothing).
The batch's scenes are built side by side; ``order`` is the stable key
sort of each scene's input rows, which the gather ``MinkUNet`` uses to
take features in and give them back in input order.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geom.voxelize import INVALID_KEY, ravel_grid_coords, unravel_key


def kernel_offsets(size: int, dim: int = 3) -> np.ndarray:
    """Integer offsets of a cubic kernel in (x, y, z) lexicographic order:
    odd sizes centred, even sizes over [0, size) (ME's conventions)."""
    if size % 2 == 1:
        r = range(-(size // 2), size // 2 + 1)
    else:
        r = range(0, size)
    return np.asarray(list(itertools.product(r, repeat=dim)), dtype=np.int32)


class SparseLevel(NamedTuple):
    coords: torch.Tensor  # (B, M, 3) int32, level units, key-ascending
    keys: torch.Tensor    # (B, M) int32 packed keys, INVALID_KEY on padding
    mask: torch.Tensor    # (B, M) bool occupancy


class UNetTopology(NamedTuple):
    """Everything one gather-UNet forward needs. ``levels[l]`` holds the
    voxel set at stride 2**l; a miss in a map equals that level's
    capacity."""

    levels: Tuple[SparseLevel, ...]
    stem_map: torch.Tensor               # (B, K5, M0) k5 map at level 0
    k3_maps: Tuple[torch.Tensor, ...]    # (B, 27, M_l) per level
    down_maps: Tuple[torch.Tensor, ...]  # (B, 8, M_{l+1}) children in l
    up_parent: Tuple[torch.Tensor, ...]  # (B, M_l) parent row in l+1
    up_offset: Tuple[torch.Tensor, ...]  # (B, M_l) child offset in [0, 8)
    order: torch.Tensor                  # (B, M0) input row of each slot
    dropped: torch.Tensor                # (B, L) int32 voxels lost


def _lookup(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Row of each query key in the sorted (B, M) ``keys``, M where it is
    absent; queries (B, ...)."""
    b, m = keys.shape
    q = queries.reshape(b, -1)
    idx = torch.searchsorted(keys, q).clamp(max=m - 1)
    found = (q != INVALID_KEY) & (torch.gather(keys, 1, idx) == q)
    return torch.where(found, idx, m).to(torch.int32).reshape(queries.shape)


def _neighbor_map(level: SparseLevel, offsets: np.ndarray, bits: int
                  ) -> torch.Tensor:
    """(B, K, M) rows of coords + offset within the level; M on a miss."""
    off = torch.as_tensor(offsets, device=level.coords.device)
    nbr = level.coords[:, None, :, :] + off[None, :, None, :]
    valid = level.mask[:, None, :].expand(nbr.shape[:3])
    return _lookup(level.keys, ravel_grid_coords(nbr, bits=bits,
                                                 valid=valid))


def _unique_sorted_keys(keys: torch.Tensor, capacity: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted (B, N) keys -> (unique keys (B, capacity), mask, number of
    unique keys past the capacity (B,))."""
    b = keys.shape[0]
    prev = torch.cat([keys.new_full((b, 1), -1), keys[:, :-1]], dim=1)
    heads = (keys != prev) & (keys != INVALID_KEY)
    ids = torch.cumsum(heads, dim=1) - 1
    dst = torch.where(heads & (ids < capacity), ids, capacity)
    out = keys.new_full((b, capacity + 1), INVALID_KEY)
    out.scatter_(1, dst, torch.where(dst < capacity, keys, INVALID_KEY))
    n = heads.sum(1)
    mask = torch.arange(capacity, device=keys.device) < n[:, None]
    return (out[:, :capacity].contiguous(), mask,
            (n - capacity).clamp(min=0))


def _downsample_level(level: SparseLevel, capacity: int, bits: int):
    """Level l -> (level l+1, down_map (B, 8, Mc), up_parent (B, Mf),
    up_offset (B, Mf), coarse voxels past the capacity (B,))."""
    parent_coords = level.coords >> 1
    parent_keys = ravel_grid_coords(parent_coords, bits=bits,
                                    valid=level.mask)
    coarse_keys, coarse_mask, lost = _unique_sorted_keys(
        torch.sort(parent_keys, dim=1).values, capacity)
    coarse_coords = torch.where(coarse_mask[..., None],
                                unravel_key(coarse_keys, bits), 0)
    coarse = SparseLevel(coords=coarse_coords, keys=coarse_keys,
                         mask=coarse_mask)
    child = (coarse_coords[:, None, :, :] * 2 + torch.as_tensor(
        kernel_offsets(2), device=coarse_coords.device)[None, :, None, :])
    down_map = _lookup(level.keys, ravel_grid_coords(
        child, bits=bits,
        valid=coarse_mask[:, None, :].expand(child.shape[:3])))
    up_parent = _lookup(coarse_keys, parent_keys)
    rel = level.coords & 1
    up_offset = (rel[..., 0] * 4 + rel[..., 1] * 2 + rel[..., 2])
    up_offset = torch.where(level.mask, up_offset, 0).to(torch.int32)
    return coarse, down_map, up_parent, up_offset, lost


def build_unet_topology(coords: torch.Tensor, mask: torch.Tensor,
                        num_levels: int = 5, stem_kernel: int = 5,
                        bits: int = 10,
                        capacities: Optional[Sequence[int]] = None
                        ) -> UNetTopology:
    """The coordinate pyramid and kernel maps of one UNet forward, on the
    device of ``coords``.

    coords (B, M, 3) or (M, 3) int voxel coords at stride 1; mask (B, M)
    or (M,). ``capacities``: per-level voxel counts, level 0 equal to M;
    the default halves per level (at least min(M, 64)): surface-like
    scenes lose at least half their voxels per halving. A coarse voxel
    past its level's capacity is dropped (the highest keys) and counted
    in ``dropped``. An unbatched input gives a topology with B = 1."""
    if coords.dim() == 2:
        coords, mask = coords[None], mask[None]
    m = coords.shape[1]
    caps = (tuple(int(c) for c in capacities) if capacities is not None
            else tuple(max(m >> lvl, min(m, 64))
                       for lvl in range(num_levels)))
    if len(caps) != num_levels or caps[0] != m:
        raise ValueError(f"capacities {caps}: want {num_levels} levels, "
                         f"level 0 equal to the input's {m} rows")
    mask = mask.bool()
    keys = ravel_grid_coords(coords, bits=bits, valid=mask)
    out_of_range = (mask & (keys == INVALID_KEY)).sum(1)
    keys, order = torch.sort(keys, dim=1, stable=True)
    coords = torch.gather(coords.to(torch.int32), 1,
                          order[..., None].expand(-1, -1, 3))
    lmask = keys != INVALID_KEY
    level = SparseLevel(coords=torch.where(lmask[..., None], coords, 0),
                        keys=keys, mask=lmask)
    levels, down_maps, up_parents, up_offsets = [level], [], [], []
    dropped = [out_of_range]
    for lvl in range(1, num_levels):
        level, dmap, up_p, up_o, lost = _downsample_level(level, caps[lvl],
                                                          bits)
        levels.append(level)
        down_maps.append(dmap)
        up_parents.append(up_p)
        up_offsets.append(up_o)
        dropped.append(lost)
    k3 = kernel_offsets(3)
    return UNetTopology(
        levels=tuple(levels),
        stem_map=_neighbor_map(levels[0], kernel_offsets(stem_kernel), bits),
        k3_maps=tuple(_neighbor_map(lv, k3, bits) for lv in levels),
        down_maps=tuple(down_maps), up_parent=tuple(up_parents),
        up_offset=tuple(up_offsets), order=order,
        dropped=torch.stack(dropped, -1).to(torch.int32))
