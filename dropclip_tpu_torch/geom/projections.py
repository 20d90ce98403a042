"""Projection primitives: unproject depth maps, project point clouds,
pair per-pixel 2D features with 3D points.

Port of ``dropclip_tpu/geom/projections.py`` (reference
utils/projections.py:59-261 and the projection block of
utils/feature_fusion.py:90-112), batched over leading axes where the
JAX functions are. Torch ops on the inputs' device;
``pool_multiview_features`` runs on the host (numpy), as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def depth_to_pointcloud(depth: torch.Tensor, K: torch.Tensor
                        ) -> torch.Tensor:
    """Unproject (..., H, W) depth maps to (..., H*W, 3) camera-frame
    clouds. Invalid (<= 0) depths give points at the origin."""
    h, w = depth.shape[-2:]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    z = depth
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    pts = torch.stack([x, y.expand_as(z), z], dim=-1)
    return pts.reshape(*depth.shape[:-2], h * w, 3)


def _project(points_camera: torch.Tensor, K: torch.Tensor):
    uvw = (K[:, :] * points_camera[..., None, :]).sum(dim=-1)
    z = uvw[..., 2]
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    uv = uvw[..., :2] / safe_z[..., None]
    return torch.where((z == 0)[..., None], torch.zeros_like(uv), uv), z


def pointcloud_to_pixel(points_camera: torch.Tensor, K: torch.Tensor
                        ) -> torch.Tensor:
    """Camera-frame points -> continuous pixel coords (..., 2) = (u, v)."""
    return _project(points_camera, K)[0]


def project_points(points_camera: torch.Tensor, K: torch.Tensor,
                   width: int, height: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera-frame points -> (uv (..., 2) int32 truncated toward zero,
    0 where z == 0; z (...,); inside (...,) bool, 0 <= u < W and
    0 <= v < H)."""
    uv_f, z = _project(points_camera, K)
    uv = torch.trunc(uv_f).to(torch.int32)
    inside = ((uv[..., 0] >= 0) & (uv[..., 1] >= 0)
              & (uv[..., 0] < width) & (uv[..., 1] < height))
    return uv, z, inside


def reconstruct_feature_map(feat: torch.Tensor, image_hw: Tuple[int, int]
                            ) -> torch.Tensor:
    """Nearest-neighbour upsample of a (ph, pw, C) patch feature map to
    (H, W, C) by integer-grid indexing (reference
    utils/transforms.py:149-164)."""
    h, w = image_hw
    ph, pw = feat.shape[:2]
    f32 = dict(dtype=torch.float32, device=feat.device)
    ys = (torch.arange(h, **f32) * (ph / h)).to(torch.int64)
    xs = (torch.arange(w, **f32) * (pw / w)).to(torch.int64)
    return feat[ys[:, None], xs[None, :]]


def bicubic_upsample(feat: torch.Tensor, image_hw: Tuple[int, int]
                     ) -> torch.Tensor:
    """Bicubic upsample of a (ph, pw, C) patch feature map to (H, W, C):
    torch ``F.interpolate(mode='bicubic', align_corners=False)`` parity
    (reference utils/feature_fusion.py:167-172) through
    ``ops.resize.bicubic_resize``."""
    from ..ops.resize import bicubic_resize

    return bicubic_resize(feat, image_hw)


def project_2d_features_to_3d(depth, features, K,
                              center_crop: Optional[int] = None,
                              transform_coords: Optional[Callable] = None,
                              subsample_step: Optional[int] = None,
                              camera_pose=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair every depth pixel's 3D point with its 2D feature vector
    (reference utils/projections.py:108-147) -> (pc (N, 3), features
    (N, C)) on the inputs' device.

    depth (H, W); features (H, W, C) aligned per pixel, or a larger map
    cropped alongside the depth when ``center_crop`` is given. Then the
    per-dataset camera-axis fix (``transform_coords``), ``::step``
    subsampling and cam -> world through ``camera_pose``. The crop shifts
    the principal point by the crop offset, as the JAX package does: K
    describes the full image (the reference :118-128 projects the
    cropped depth with the uncropped intrinsics)."""
    from .transforms import transform_pointcloud_to_world_frame

    depth = torch.as_tensor(depth)
    features = torch.as_tensor(features, device=depth.device)
    K = torch.as_tensor(K, device=depth.device)
    if center_crop:
        def crop(img, size):
            h, w = img.shape[:2]
            y0, x0 = (h - size) // 2, (w - size) // 2
            return img[y0: y0 + size, x0: x0 + size], (x0, y0)

        depth, (x0, y0) = crop(depth, center_crop)
        if features.shape[:2] != depth.shape[:2]:
            features = crop(features, center_crop)[0]
        K = K.clone()
        K[0, 2] -= x0
        K[1, 2] -= y0
    pc = depth_to_pointcloud(depth, K).reshape(-1, 3)
    features = features.reshape(-1, features.shape[-1])
    if transform_coords is not None:
        pc = transform_coords(pc)
    if subsample_step:
        pc = pc[::subsample_step]
        features = features[::subsample_step]
    if camera_pose is not None:
        pc = transform_pointcloud_to_world_frame(
            pc, torch.as_tensor(camera_pose, device=pc.device))
    return pc, features


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pool_multiview_features(aggr_pc, aggr_features
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Max-pool features over duplicate 3D points (reference
    utils/projections.py:245-261), on the host (numpy): it runs once per
    scene of offline ingest. Returns (unique_points (U, 3), pooled
    (U, C))."""
    aggr_pc = _host(aggr_pc)
    aggr_features = _host(aggr_features)
    uniq, inv = np.unique(aggr_pc, axis=0, return_inverse=True)
    pooled = np.full((len(uniq), aggr_features.shape[-1]), -np.inf,
                     aggr_features.dtype)
    np.maximum.at(pooled, inv.reshape(-1), aggr_features)
    return uniq, pooled
