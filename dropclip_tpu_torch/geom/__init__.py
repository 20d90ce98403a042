"""Point-cloud geometry: transforms, projections, voxelization,
multi-view aggregation, cleanup."""

from .camera import CameraIntrinsics
from .cleanup import (
    pc_outlier_removal,
    pc_voxel_down,
    plane_removal,
    remove_stat_outlier,
    segment_plane,
)
from .projections import (
    depth_to_pointcloud,
    pointcloud_to_pixel,
    project_points,
    reconstruct_feature_map,
)
from .transforms import (
    flip_yz,
    transform_pointcloud_to_camera_frame,
    transform_pointcloud_to_world_frame,
    transform_poses_to_camera_frame,
    transform_poses_to_world_frame,
)
from .voxelize import ravel_grid_coords, sparse_quantize, voxel_downsample
