"""Pillar-engine topology: xy-site pyramids + neighbour/child tables.

Port of ``dropclip_tpu/sparse/pillar_topology.py``. The builder runs on
the host (numpy), as in the JAX package: topology is a per-scene set-up
cost of the pillar engine, an inference backend for volumetric scenes.
Its tables go to the caller's device as int32 / bool tensors.

Coordinate semantics mirror MinkowskiEngine: level l+1 voxels are
``unique(floor(c/2))`` of level l's occupied voxels; the transpose reuses
the encoder's fine sites. Pillar heights halve per level (Z0 a multiple
of 16), and z is shifted to [0, Z0) by an offset aligned to
2^(levels-1), so every halving lattice stays the absolute one.

The tables are element for element the JAX builder's (sites in
``np.unique`` order, capacity overflow dropping the highest-keyed sites),
built with sorted packed xy keys and ``searchsorted`` instead of per-site
dictionary loops. An empty cloud gives empty levels; a scene taller than
a frozen ``z0`` raises a ValueError naming ``pillar_z0``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


class PillarLevel(NamedTuple):
    xy: torch.Tensor      # (P, 2) int32 site coords (level units)
    occ: torch.Tensor     # (P, Z_l) bool voxel occupancy
    nbr9: torch.Tensor    # (P, 9) int32 xy neighbours (dx-major), miss -> P
    mask: torch.Tensor    # (P,) bool site validity (padding rows False)


class PillarTopology(NamedTuple):
    levels: Tuple[PillarLevel, ...]
    nbr25: torch.Tensor                   # (P0, 25) stem k5 xy table
    child: Tuple[torch.Tensor, ...]       # (P_{l+1}, 4) fine rows, miss->P_l
    parent: Tuple[torch.Tensor, ...]      # (P_l,) coarse row per fine pillar
    xy_parity: Tuple[torch.Tensor, ...]   # (P_l,) (x&1)*2 + (y&1)
    point_pillar: torch.Tensor            # (M,) level-0 pillar row per point
    point_z: torch.Tensor                 # (M,) level-0 z slot per point
    z_offset: int                         # world z = z + z_offset
    dropped: int                          # capacity-truncated sites


_Y_BIAS = 1 << 31


def _keys(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Packed int64 xy keys, ordered as (x, y) lexicographically."""
    return (x.astype(np.int64) << 32) + (y.astype(np.int64) + _Y_BIAS)


def _unpack(keys: np.ndarray) -> np.ndarray:
    return np.stack([keys >> 32, (keys & 0xFFFFFFFF) - _Y_BIAS],
                    axis=-1).astype(np.int32)


def _lookup(sites: np.ndarray, q: np.ndarray, miss: int) -> np.ndarray:
    """Row of each key of ``q`` in the sorted ``sites``, else ``miss``."""
    if len(sites) == 0:
        return np.full(q.shape, miss, np.int32)
    i = np.searchsorted(sites, q)
    hit = sites[np.minimum(i, len(sites) - 1)] == q
    return np.where(hit, i, miss).astype(np.int32)


def _site_tables(sites: np.ndarray, cap: int, r: int) -> np.ndarray:
    """(cap, (2r+1)^2) xy-neighbour table of one level (dx-major, dy
    ascending), miss -> cap; padding rows stay all-miss."""
    xy = _unpack(sites)
    d = np.arange(-r, r + 1)
    dx, dy = np.repeat(d, len(d)), np.tile(d, len(d))
    q = _keys(xy[:, :1] + dx, xy[:, 1:] + dy)
    tab = np.full((cap, len(dx)), cap, np.int32)
    tab[: len(sites)] = _lookup(sites, q, cap)
    return tab


def build_pillar_topology(coords, mask, num_levels: int = 5,
                          z0: Optional[int] = None,
                          site_capacities: Optional[Sequence[int]] = None,
                          device=None) -> PillarTopology:
    """Build the pillar pyramid for ONE scene.

    coords (M, 3) int voxel coords (any origin); mask (M,) bool. z0: the
    level-0 pillar height (a multiple of 16; default fits the data).
    site_capacities: per-level pillar-row padding (default exact fit);
    overflow drops the highest-keyed sites and counts them in
    ``dropped``. Tensors land on ``device`` (the card unless given).
    """
    device = resolve_device(device)
    coords = np.asarray(coords).astype(np.int64)
    mask = np.asarray(mask, bool)
    occ_c = coords[mask]
    # The z shift MUST be a multiple of 2^(num_levels-1): the pyramid is
    # floor(c / 2^l) in absolute coordinates, and any other shift
    # misaligns every halving lattice.
    align = 1 << (num_levels - 1)
    z_off = align * (int(occ_c[:, 2].min()) // align) if len(occ_c) else 0
    zext = int(occ_c[:, 2].max()) - z_off + 1 if len(occ_c) else 0
    if z0 is None:
        z0 = max(16, 16 * ((zext + 15) // 16))
    if z0 % 16:
        raise ValueError(f"pillar_z0 {z0} is not a multiple of 16")
    if zext > z0:
        raise ValueError(
            f"scene spans {zext} z voxels (offset {z_off}), more than the "
            f"frozen pillar_z0 {z0}; pass a larger pillar_z0")

    vox = occ_c - np.array([[0, 0, z_off]])
    levels_np = []  # (site keys, occ, cap)
    dropped = 0
    for lvl in range(num_levels):
        sites, inv = np.unique(_keys(vox[:, 0], vox[:, 1]),
                               return_inverse=True)
        inv = inv.reshape(-1)
        cap = len(sites)
        vox_l = vox
        if site_capacities is not None:
            cap = int(site_capacities[lvl])
            if len(sites) > cap:  # keys are sorted: drop the highest
                dropped += len(sites) - cap
                keep = inv < cap
                sites, vox_l, inv = sites[:cap], vox[keep], inv[keep]
        occ = np.zeros((cap, z0 >> lvl), bool)
        occ[inv, vox_l[:, 2]] = True
        levels_np.append((sites, occ, cap))
        vox = np.unique(vox_l // 2, axis=0)  # floor: next level's voxels

    def t(a):
        return torch.as_tensor(a, device=device)

    levels = tuple(
        PillarLevel(xy=t(np.pad(_unpack(sites), ((0, cap - len(sites)),
                                                 (0, 0)))),
                    occ=t(occ), nbr9=t(_site_tables(sites, cap, 1)),
                    mask=t(np.arange(cap) < len(sites)))
        for sites, occ, cap in levels_np)
    childs, parents, parities = [], [], []
    for (s_f, _, cap_f), (s_c, _, cap_c) in zip(levels_np, levels_np[1:]):
        xy_f, xy_c = _unpack(s_f), _unpack(s_c)
        child = np.full((cap_c, 4), cap_f, np.int32)
        child[: len(s_c)] = _lookup(
            s_f, _keys(2 * xy_c[:, :1] + np.array([0, 0, 1, 1]),
                       2 * xy_c[:, 1:] + np.array([0, 1, 0, 1])), cap_f)
        parent = np.full((cap_f,), cap_c, np.int32)
        parent[: len(s_f)] = _lookup(
            s_c, _keys(xy_f[:, 0] >> 1, xy_f[:, 1] >> 1), cap_c)
        parity = np.zeros((cap_f,), np.int32)
        parity[: len(s_f)] = (xy_f[:, 0] & 1) * 2 + (xy_f[:, 1] & 1)
        childs.append(t(child))
        parents.append(t(parent))
        parities.append(t(parity))

    # per-point extraction map at level 0 (masked-out points -> pad row)
    s0, _, cap0 = levels_np[0]
    rows = _lookup(s0, _keys(coords[:, 0], coords[:, 1]), cap0)
    pp = np.where(mask, rows, cap0).astype(np.int32)
    pz = np.where(mask, np.clip(coords[:, 2] - z_off, 0, z0 - 1),
                  0).astype(np.int32)
    return PillarTopology(
        levels=levels, nbr25=t(_site_tables(s0, cap0, 2)),
        child=tuple(childs), parent=tuple(parents),
        xy_parity=tuple(parities), point_pillar=t(pp), point_z=t(pz),
        z_offset=z_off, dropped=dropped)


def scatter_points_pillar(feats: torch.Tensor, topo: PillarTopology
                          ) -> torch.Tensor:
    """(M, C) point features -> (P0, Z0, C) pillar-dense, zeros elsewhere.
    Masked-out points all land on the pad row, which is sliced off."""
    p0, z0 = topo.levels[0].occ.shape
    flat = feats.new_zeros(((p0 + 1) * z0, feats.shape[-1]))
    flat[topo.point_pillar.long() * z0 + topo.point_z.long()] = feats
    return flat.reshape(p0 + 1, z0, -1)[:p0]


def gather_points_pillar(dense: torch.Tensor, topo: PillarTopology
                         ) -> torch.Tensor:
    """(P0, Z0, C) pillar-dense -> (M, C) per input point (pad -> 0)."""
    p0, z0, c = dense.shape
    flat = torch.cat([dense.reshape(p0 * z0, c), dense.new_zeros((z0, c))])
    return flat[topo.point_pillar.long() * z0 + topo.point_z.long()]
