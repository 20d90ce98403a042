"""Sparse convolution primitives of the gather engine: gather, GEMM, sum.

Port of ``dropclip_tpu/sparse/ops.py`` (MinkowskiEngine's gather-GEMM-
scatter convolutions, every ``ME.MinkowskiConvolution[Transpose]`` of
reference models/distil/minkunet.py):

- a sparse conv over a kernel map ``nbr (K, M_out)`` is ``out = sum_k
  feats[nbr[k]] @ W[k]``; here the K gathered blocks sit side by side as
  one (M_out, K * Cin) operand and one matmul against W reshaped to
  (K * Cin, Cout) sums the taps, accumulating in float32 (the JAX scan's
  ``preferred_element_type``) before the cast back to the input's dtype;
- a miss or a padded slot indexes row ``M_in``, a zero row appended to
  the features, so it contributes nothing;
- the transposed k2s2 conv projects every coarse voxel through all 8
  offset weights (``H_o = feats @ W[o]``) and gathers ``H[offset(i),
  parent(i)]`` for each fine voxel.

Everything is shaped (B, M, C) or (M, C); none of it is a TPU kernel in
the JAX package, so these stay torch ops.
"""

from __future__ import annotations

from typing import Optional

import torch


def _pad_zero_row(x: torch.Tensor) -> torch.Tensor:
    """Append one zero row along the row axis (-2): index M reads zeros."""
    zero = x.new_zeros(tuple(x.shape[:-2]) + (1, x.shape[-1]))
    return torch.cat([x, zero], dim=-2)


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (M, C) or (B, M, C), idx (...) or (B, ...) -> (..., C) or
    (B, ..., C)."""
    if table.dim() == 2:
        return table[idx]
    b = table.shape[0]
    flat = idx.reshape(b, -1)
    rows = torch.arange(b, device=idx.device)[:, None]
    return table[rows, flat].reshape(tuple(idx.shape) + (table.shape[-1],))


def gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with the zero-row convention: feats (M, C) or (B, M, C),
    idx (...) or (B, ...), the value M meaning a miss (zeros)."""
    return _take_rows(_pad_zero_row(feats), idx.long())


def _masked(out: torch.Tensor, out_mask: Optional[torch.Tensor]
            ) -> torch.Tensor:
    if out_mask is None:
        return out
    return out * out_mask[..., None].to(out.dtype)


def sparse_conv(feats: torch.Tensor, nbr_map: torch.Tensor,
                weights: torch.Tensor,
                out_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse convolution over a kernel map.

    feats (B, M_in, Cin) or (M_in, Cin); nbr_map (B, K, M_out) or
    (K, M_out); weights (K, Cin, Cout), ME's kernel layout. Covers the
    stride-1 convs (a level's neighbour map) and the k2s2 down-convs (a
    down map into the finer level)."""
    k, cin, cout = weights.shape
    g = gather_rows(feats, nbr_map.transpose(-1, -2))  # (..., M_out, K, Cin)
    g = g.reshape(tuple(g.shape[:-2]) + (k * cin,))
    acc = torch.matmul(g.float(), weights.reshape(k * cin, cout).float())
    return _masked(acc.to(feats.dtype), out_mask)


def sparse_conv_transpose(coarse_feats: torch.Tensor, up_parent: torch.Tensor,
                          up_offset: torch.Tensor, weights: torch.Tensor,
                          out_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Transposed k2s2 sparse conv, coarse level -> the encoder's fine
    level: fine voxel i takes its parent's features through W[offset(i)]
    (reference ME.MinkowskiConvolutionTranspose, kernel 2 stride 2,
    minkunet.py:81-104). coarse_feats (B, Mc, Cin) or (Mc, Cin);
    up_parent and up_offset (B, Mf) or (Mf,), a parent >= Mc a miss;
    weights (8, Cin, Cout)."""
    k = weights.shape[0]
    mc = coarse_feats.shape[-2]
    h = torch.einsum("...mc,kcd->...kmd", coarse_feats.float(),
                     weights.float()).to(coarse_feats.dtype)
    h = h.reshape(tuple(h.shape[:-3]) + (k * mc, h.shape[-1]))
    parent = up_parent.long()
    flat = torch.where(parent >= mc, k * mc,
                       up_offset.long() * mc + parent.clamp(max=mc - 1))
    return _masked(_take_rows(_pad_zero_row(h), flat), out_mask)
