"""Object-level multi-view feature fusion.

Port of ``dropclip_tpu/fusion/core.py`` (reference
utils/feature_fusion.py:15-350, ``MultiviewFeatureFusion``): visibility of
3D points in every view (projection plus the ``|sensor - z| <= 0.05``
depth test), and object-level fusion of per-view teacher features weighted
by presence, pixel count or relative similarity to the text queries, with
per-view min-max normalisation of the similarity matrices and NaN rows for
objects never fused (the ingest tool replaces them with their text
embedding). Views are one batched axis.

Point-level fusion (``fuse_points``) samples each view's teacher patch
features at the points' pixels (``ops.resize.bicubic_sample_at``, no
full-resolution map), weights them by visibility or by the relative
similarity of the pixel's own object query, and accumulates one (N, C)
float32 sum over a loop of views (the JAX ``lax.scan``); points seen in no
view get NaN rows, as in the reference. ``fuse`` dispatches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..geom.projections import project_points
from ..geom.transforms import flip_yz, transform_pointcloud_to_camera_frame
from ..ops.resize import bicubic_sample_at


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


def _project_view(points: torch.Tensor, camera_poses: torch.Tensor,
                  K: torch.Tensor, width: int, height: int):
    """World points -> (uv int, point depth, inside) in each view of
    ``camera_poses`` (V, 4, 4) (the projection block of
    feature_fusion.py:90-112)."""
    cam = flip_yz(transform_pointcloud_to_camera_frame(points, camera_poses))
    return project_points(cam, K, width, height)


def _view_visibility(points: torch.Tensor, depths: torch.Tensor,
                     camera_poses: torch.Tensor, K: torch.Tensor,
                     cfg: FusionConfig):
    """(ui, vi, visible), each (V, N): the clamped pixel of each point in
    each view and the depth test (feature_fusion.py:81-125)."""
    h, w = cfg.image_hw
    uv, z, inside = _project_view(points, camera_poses, K, w, h)
    ui = uv[..., 0].clamp(0, w - 1).to(torch.int64)
    vi = uv[..., 1].clamp(0, h - 1).to(torch.int64)
    views = torch.arange(depths.shape[0], device=depths.device)[:, None]
    sensor = depths[views, vi, ui]
    return ui, vi, inside & ((sensor - z).abs() <= cfg.visibility_threshold)


def visibility_mask(points: torch.Tensor, depths: torch.Tensor,
                    camera_poses: torch.Tensor, K: torch.Tensor,
                    cfg: FusionConfig) -> torch.Tensor:
    """(V, N) bool visibility of each world point in each view."""
    return _view_visibility(points, depths, camera_poses, K, cfg)[2]


def borderline_points(points: torch.Tensor, depths: torch.Tensor,
                      camera_poses: torch.Tensor, K: torch.Tensor,
                      cfg: FusionConfig, eps: float = 1e-4) -> torch.Tensor:
    """(V, N) bool: the float64 projection of a point lies within ``eps``
    of an integer pixel coordinate, or its depth test within ``eps`` of
    the threshold. There the truncating projection and the depth test
    turn on the last bit of a float32 product, so two correct float32
    programs may disagree (points aggregated from a view project back
    onto exact integer pixels of it)."""
    h, w = cfg.image_hw
    inv = torch.linalg.inv(camera_poses.to(torch.float64))  # (V, 4, 4)
    cam = flip_yz((inv[:, None, :3, :3] @ points.to(torch.float64)[
        None, :, :, None])[..., 0] + inv[:, None, :3, 3])
    uvw = cam @ K.to(torch.float64).T
    z = uvw[..., 2]
    uv = uvw[..., :2] / torch.where(z == 0, 1.0, z)[..., None]
    near_int = ((uv - uv.round()).abs() < eps).any(-1)
    ui = uv[..., 0].trunc().clamp(0, w - 1).long()
    vi = uv[..., 1].trunc().clamp(0, h - 1).long()
    views = torch.arange(depths.shape[0], device=depths.device)[:, None]
    sensor = depths.to(torch.float64)[views, vi, ui]
    near_depth = ((sensor - z).abs() - cfg.visibility_threshold).abs() < eps
    return near_int | near_depth


def _point_sim_metric(feat_pts: torch.Tensor, seg_pts: torch.Tensor,
                      query_embs: torch.Tensor, cfg: FusionConfig
                      ) -> torch.Tensor:
    """Per-point semantic informativeness (feature_fusion.py:176-196):
    the relative similarity of the pixel's own object query (seg id
    ``seg_pts``) against all other queries; 0 where the seg id is outside
    [0, Q) (the reference never writes those)."""
    q = query_embs.shape[0]
    raw = feat_pts.float() @ query_embs.float().T  # (N, Q)
    in_range = (seg_pts >= 0) & (seg_pts < q)
    sid = seg_pts.to(torch.int64).clamp(0, q - 1)
    pos = raw.gather(1, sid[:, None])[:, 0]
    if cfg.sim_kernel == "max":
        own = torch.nn.functional.one_hot(sid, q).bool()
        ref = torch.where(own, -torch.inf, raw).amax(-1)
    else:  # mean over the Q-1 other queries
        ref = (raw.sum(-1) - pos) / max(q - 1, 1)
    metric = (pos - ref).clamp_min(cfg.eps)
    return torch.where(in_range, metric, 0.0)


class FusedPoints(NamedTuple):
    features: torch.Tensor    # (N, C) fused per-point features
    visibility: torch.Tensor  # (V, N) bool
    similarity: torch.Tensor  # (V, N) f32 per-view weights (zeros if unused)
    visible: torch.Tensor     # (N,) bool, seen in >= 1 view


def fuse_points(points: torch.Tensor, depths: torch.Tensor,
                seg_masks: torch.Tensor, camera_poses: torch.Tensor,
                patch_feats: torch.Tensor,
                query_embs: Optional[torch.Tensor], K: torch.Tensor,
                cfg: FusionConfig) -> FusedPoints:
    """Point-level fusion (reference aggregate_features + fuse_points,
    feature_fusion.py:139-270).

    points (N, 3) world; depths (V, H, W); seg_masks (V, H, W) int;
    camera_poses (V, 4, 4) cam->world; patch_feats (V, ph, pw, C) teacher
    patch features; query_embs (Q, C) normalized text queries (required
    with ``use_similarity``)."""
    h, w = cfg.image_hw
    if cfg.use_similarity and query_embs is None:
        raise ValueError("query_embs required when use_similarity")
    sum_feat = torch.zeros((points.shape[0], patch_feats.shape[-1]),
                           dtype=torch.float32, device=points.device)
    vis, wgts = [], []
    for v in range(depths.shape[0]):
        ui, vi, visible = (x[0] for x in _view_visibility(
            points, depths[v:v + 1], camera_poses[v:v + 1], K, cfg))
        feat_pts = bicubic_sample_at(patch_feats[v], (h, w), ui, vi)
        if cfg.norm_feat:
            feat_pts = feat_pts / torch.linalg.vector_norm(
                feat_pts, dim=-1, keepdim=True)
        if cfg.use_similarity:
            metric = _point_sim_metric(feat_pts, seg_masks[v][vi, ui],
                                       query_embs, cfg)
            wgt = torch.where(visible, metric, 0.0)
        else:
            wgt = visible.float()
        sum_feat += torch.where(visible[:, None], feat_pts * wgt[:, None],
                                0.0)
        vis.append(visible)
        wgts.append(wgt)
    vis, wgts = torch.stack(vis), torch.stack(wgts)
    divisor = wgts.sum(0) if cfg.use_similarity else vis.float().sum(0)
    return FusedPoints(
        features=sum_feat / divisor[:, None],  # NaN where never visible
        visibility=vis,
        similarity=wgts if cfg.use_similarity else torch.zeros_like(wgts),
        visible=vis.any(0))


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


def fuse(points, depths, seg_masks, camera_poses, mv_features, query_embs,
         K, cfg: FusionConfig, use_obj_prior: bool = True,
         obj_present: Optional[torch.Tensor] = None):
    """Object-level or point-level fusion (reference
    feature_fusion.py:345-350)."""
    if use_obj_prior:
        if obj_present is None:
            raise ValueError("object-level fusion needs obj_present")
        return fuse_obj_prior(points, depths, seg_masks, camera_poses,
                              mv_features, obj_present, query_embs, K, cfg)
    return fuse_points(points, depths, seg_masks, camera_poses, mv_features,
                       query_embs, K, cfg)
