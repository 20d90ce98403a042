"""Multi-view RGB-D aggregation to a labeled world-frame cloud.

Port of ``dropclip_tpu/geom/aggregate.py`` (replacing the reference's
Open3D pipeline, utils/geometry.py:120-204): per view, unproject the
depth pixels, apply the Blender/o3d camera-axis flip, transform
cam->world with the view's world matrix, then voxel-downsample all views
together with mean position and colour and a majority label per voxel.
All views are one batched computation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .projections import depth_to_pointcloud
from .transforms import flip_yz, transform_pointcloud_to_world_frame
from .voxelize import voxel_downsample


def unproject_views(depths: torch.Tensor, rgbs: torch.Tensor,
                    segs: torch.Tensor, camera_poses: torch.Tensor,
                    K: torch.Tensor, depth_trunc: float = 25.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """(V, H, W[, 3]) images -> flat world-frame cloud (V*H*W rows):
    (points, colors, labels, valid), valid where 0 < depth < depth_trunc.
    uint8 colours become 0..1 floats."""
    if rgbs.dtype == torch.uint8:
        rgbs = rgbs.to(torch.float32) / 255.0
    cam = flip_yz(depth_to_pointcloud(depths, K))  # (V, H*W, 3)
    world = transform_pointcloud_to_world_frame(cam, camera_poses)
    d = depths.reshape(-1)
    valid = (d > 0) & (d < depth_trunc)
    return (world.reshape(-1, 3), rgbs.reshape(-1, rgbs.shape[-1]),
            segs.reshape(-1), valid)


def aggregate_views(depths: torch.Tensor, rgbs: torch.Tensor,
                    segs: torch.Tensor, camera_poses: torch.Tensor,
                    K: torch.Tensor, voxel_size: Optional[float],
                    capacity: int, num_labels: int,
                    depth_trunc: float = 25.0, bits: int = 10):
    """Unproject all views and voxel-downsample. Returns (xyz (cap, 3),
    rgb (cap, 3), labels (cap,), mask (cap,), dropped () int32)."""
    pts, cols, labs, valid = unproject_views(depths, rgbs, segs,
                                             camera_poses, K, depth_trunc)
    assert voxel_size is not None and voxel_size > 0
    return voxel_downsample(pts, cols, labs, voxel_size, capacity,
                            num_label_classes=num_labels, valid=valid,
                            bits=bits)
