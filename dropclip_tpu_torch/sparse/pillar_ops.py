"""Pillar-layout sparse conv operators as plain torch ops.

Port of ``dropclip_tpu/sparse/pillar_ops.py``. Voxels live as full-height
z-columns (P, Z, C) at occupied (x, y) sites ("pillars"). This module
holds every operator the pillar MinkUNet needs besides the k3 stage conv
(K2, ``kernels/pillar_conv3.py``): the odd-kernel submanifold conv (the k5
stem), the k2s2 down conv and its transpose.

Weight layouts are reshapes of the canonical lexicographic
``(K**3, Cin, Cout)`` kernels the brick engine stores (dz fastest, then
dy, then dx), so the engines share checkpoints:

  k odd:  (K^3, C, Co) -> (K^2 xy-dirs, K dz, C, Co)   [dx-major xy]
  k2s2:   (8, C, Co)   -> (4 xy-children, 2 dz, C, Co)

A neighbour, child or parent row outside [0, P) is a miss and reads zeros
(the JAX package points misses at an appended zero row P).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``feats[idx]`` over the leading axis, zeros where ``idx`` lies
    outside [0, len(feats))."""
    p = feats.shape[0]
    fz = torch.cat([feats, feats.new_zeros((1,) + feats.shape[1:])])
    idx = idx.long()
    return fz[torch.where((idx >= 0) & (idx < p), idx, p)]


def z_shift(cols: torch.Tensor, dz: int, axis: int = -2) -> torch.Tensor:
    """shifted[..., z, :] = cols[..., z + dz, :] along ``axis``, zeros past
    the column ends (outside the scene is empty)."""
    if dz == 0:
        return cols
    z = cols.shape[axis]
    axis = axis % cols.dim()
    pad = [0, 0] * (cols.dim() - 1 - axis)
    if dz < 0:
        return F.pad(cols.narrow(axis, 0, z + dz), pad + [-dz, 0])
    return F.pad(cols.narrow(axis, dz, z - dz), pad + [0, dz])


def pillar_conv_xla(feats: torch.Tensor, nbr: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Odd-kernel submanifold conv in pillar layout.

    feats (P, Z, C), zero at unoccupied voxels; nbr (P, K^2) xy-neighbour
    pillar rows in lexicographic (dx-major) order; weights (K^2, K, C, Co)
    with dz ascending. float32 sums whatever the input dtype, cast back.
    Returns (P, Z, Co) UNMASKED: callers apply the occupancy mask (the
    following masked batch norm).
    """
    k = weights.shape[1]
    cols = gather_rows(feats, nbr).float()  # (P, K^2, Z, C)
    w = weights.float()
    out = None
    for dzi in range(k):
        y = torch.einsum("pjzc,jco->pzo", z_shift(cols, dzi - k // 2),
                         w[:, dzi])
        out = y if out is None else out + y
    return out.to(feats.dtype)


def pillar_down_conv(feats: torch.Tensor, child: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """k2s2 down conv: (P, Z, C) fine -> (P', Z/2, Co) coarse.

    child (P', 4): the fine pillar rows at xy offsets (0,0), (0,1), (1,0),
    (1,1) of each coarse site; weights (4, 2, C, Co), dz in {0, 1}. Z
    must be even.
    """
    p, z, c = feats.shape
    if z % 2:
        raise ValueError(f"pillar_down_conv needs an even Z, got {z}")
    cols = gather_rows(feats, child)  # (P', 4, Z, C)
    pairs = cols.reshape(child.shape[0], 4, z // 2, 2, c)
    out = torch.einsum("pjzdc,jdco->pzo", pairs.float(), weights.float())
    return out.to(feats.dtype)


def pillar_up_conv(feats: torch.Tensor, parent: torch.Tensor,
                   xy_parity: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """k2s2 transposed conv: (P', Z', C) coarse -> (P, 2*Z', Co) fine.

    Fine voxel (x, y, z) reads its parent (x>>1, y>>1, z>>1) through the
    weight of its octant ((x&1)*4 + (y&1)*2 + (z&1)), on the encoder's
    fine sites. parent (P,) coarse row per fine pillar; xy_parity (P,) in
    [0, 4) = (x&1)*2 + (y&1); weights (4, 2, C, Co). As in the JAX
    package, all four xy-octant products run over every pillar and each
    pillar keeps its own.
    """
    zp = feats.shape[1]
    co = weights.shape[-1]
    par = gather_rows(feats, parent).float()  # (P, Z', C)
    y = torch.einsum("pzc,jdco->pzjdo", par, weights.float())
    sel = torch.take_along_dim(
        y, xy_parity.long()[:, None, None, None, None], dim=2)[:, :, 0]
    return sel.reshape(parent.shape[0], 2 * zp, co).to(feats.dtype)
