"""Projection primitives: unproject depth maps, project point clouds.

Port of ``dropclip_tpu/geom/projections.py`` (reference
utils/projections.py:59-86 and the projection block of
utils/feature_fusion.py:90-112), batched over leading axes.
"""

from __future__ import annotations

from typing import Tuple

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
