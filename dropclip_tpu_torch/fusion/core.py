"""Object-level multi-view feature fusion.

Port of ``dropclip_tpu/fusion/core.py`` (reference
utils/feature_fusion.py:15-350, ``MultiviewFeatureFusion``): visibility of
3D points in every view (projection plus the ``|sensor - z| <= 0.05``
depth test), and object-level fusion of per-view teacher features weighted
by presence, pixel count or relative similarity to the text queries, with
per-view min-max normalisation of the similarity matrices and NaN rows for
objects never fused (the ingest tool replaces them with their text
embedding). Views are one batched axis. Point-level fusion
(``fuse_points``) waits for a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..geom.projections import project_points
from ..geom.transforms import flip_yz, transform_pointcloud_to_camera_frame


class FusionConfig(NamedTuple):
    """Fusion knobs (reference feature_fusion.py:16-53)."""

    image_hw: Tuple[int, int] = (480, 640)
    visibility_threshold: float = 0.05
    use_visibility: bool = True
    use_similarity: bool = True
    sim_kernel: str = "max"  # 'max' | 'mean'
    norm_feat: bool = True
    eps: float = 1e-6


def relative_similarity(pos: torch.Tensor, neg: torch.Tensor, kernel: str,
                        eps: float = 1e-6) -> torch.Tensor:
    """clip(pos - max/mean(neg), eps) (reference feature_fusion.py:65-73)."""
    if kernel == "max":
        ref = neg.amax(dim=-1)
    elif kernel == "mean":
        ref = neg.mean(dim=-1)
    else:
        raise ValueError(f"sim kernel must be max|mean, got {kernel!r}")
    return (pos - ref).clamp_min(eps).to(torch.float32)


def visibility_mask(points: torch.Tensor, depths: torch.Tensor,
                    camera_poses: torch.Tensor, K: torch.Tensor,
                    cfg: FusionConfig) -> torch.Tensor:
    """(V, N) bool visibility of each world point in each view."""
    h, w = cfg.image_hw
    cam = flip_yz(transform_pointcloud_to_camera_frame(points, camera_poses))
    uv, z, inside = project_points(cam, K, w, h)  # (V, N, 2), (V, N)
    ui = uv[..., 0].clamp(0, w - 1).to(torch.int64)
    vi = uv[..., 1].clamp(0, h - 1).to(torch.int64)
    views = torch.arange(depths.shape[0], device=depths.device)[:, None]
    sensor = depths[views, vi, ui]
    return inside & ((sensor - z).abs() <= cfg.visibility_threshold)


class FusedObjects(NamedTuple):
    obj_features: torch.Tensor  # (Q, C) fused per-object (NaN if unseen)
    weights: torch.Tensor       # (Q, V) per-(object, view) weights
    visibility: torch.Tensor    # (V, N) bool point visibility
    visible: torch.Tensor       # (N,) bool


def _masked_minmax(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per view: (x - min) / (max - min) over the masked (Q, Q) entries."""
    inf = torch.tensor(float("inf"), device=x.device)
    lo = torch.where(mask, x, inf).amin(dim=(-2, -1), keepdim=True)
    hi = torch.where(mask, x, -inf).amax(dim=(-2, -1), keepdim=True)
    rng = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    return (x - lo) / rng


def fuse_obj_prior(points: torch.Tensor, depths: torch.Tensor,
                   seg_masks: torch.Tensor, camera_poses: torch.Tensor,
                   obj_feats: torch.Tensor, obj_present: torch.Tensor,
                   query_embs: torch.Tensor, K: torch.Tensor,
                   cfg: FusionConfig,
                   obj_valid: Optional[torch.Tensor] = None) -> FusedObjects:
    """Object-level fusion (reference fuse_obj_prior, feature_fusion.py:
    273-343).

    obj_feats (V, Q, C): row q is object id q's feature in view v (zero
    when absent); obj_present (V, Q) bool. The (object, view) weight is
    1, then the pixel count (use_visibility), then the relative-similarity
    kernel (use_similarity), the reference's precedence. ``obj_valid``
    (Q,) marks the real rows of a padded object set; padded rows and
    columns leave the min-max and the negative sets, so results equal the
    unpadded computation."""
    v_views, q, _ = obj_feats.shape
    dev = obj_feats.device
    if obj_valid is None:
        obj_valid = torch.ones((q,), dtype=torch.bool, device=dev)
    obj_valid = obj_valid.to(dev)
    present = obj_present.to(dev) & obj_valid[None, :]

    wgt = present.to(torch.float32)  # (V, Q)
    if cfg.use_visibility:
        ids = seg_masks.reshape(v_views, -1).to(torch.int64)
        ids = torch.where((ids < 0) | (ids >= q), q, ids)  # no one-hot row
        counts = torch.zeros((v_views, q + 1), dtype=torch.float32,
                             device=dev)
        counts.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.float32))
        wgt = torch.where(present, counts[:, :q], torch.zeros_like(wgt))
    if cfg.use_similarity:
        featn = obj_feats / torch.linalg.vector_norm(obj_feats, dim=-1,
                                                     keepdim=True)
        sim = featn.to(torch.float32) @ query_embs.to(torch.float32).T
        sim = _masked_minmax(sim, present[:, :, None] & obj_valid[None, None])
        pos = torch.diagonal(sim, dim1=-2, dim2=-1)  # (V, Q)
        excl = (torch.eye(q, dtype=torch.bool, device=dev)
                | ~obj_valid[None, :])
        if cfg.sim_kernel == "max":
            ref = torch.where(excl, -torch.inf, sim).amax(dim=-1)
        else:
            n_others = obj_valid.to(torch.float32).sum() - 1.0
            ref = (torch.where(excl, 0.0, sim).sum(dim=-1)
                   / n_others.clamp_min(1.0))
        wgt = torch.where(present, (pos - ref).clamp_min(cfg.eps),
                          torch.zeros_like(wgt))

    weights = wgt.T  # (Q, V)
    feats_qvc = obj_feats.transpose(0, 1).to(torch.float32)  # (Q, V, C)
    wsum = weights.sum(dim=1)
    fused = (feats_qvc * weights[:, :, None]).sum(dim=1) / wsum[:, None]

    vis = visibility_mask(points, depths, camera_poses, K, cfg)
    return FusedObjects(obj_features=fused, weights=weights, visibility=vis,
                        visible=vis.any(dim=0))


def splat_object_features(labels: torch.Tensor, obj_features: torch.Tensor
                          ) -> torch.Tensor:
    """Per-point features = per-object features indexed by instance label,
    zeros for label 0 or out of range (reference feature_fusion.py:
    128-136)."""
    q = obj_features.shape[0]
    lab = labels.to(torch.int64).clamp(0, q - 1)
    out = obj_features[lab]
    keep = (labels > 0) & (labels < q)
    return torch.where(keep[:, None], out, torch.zeros_like(out))
