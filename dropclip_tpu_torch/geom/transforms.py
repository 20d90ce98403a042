"""SE(3) transforms for point clouds.

Port of the parts of ``dropclip_tpu/geom/transforms.py`` that ingest uses
(reference utils/transforms.py:43-61): 4x4 transforms applied as a
broadcast multiply-sum over leading batch axes, the closed-form affine
inverse, and the camera-axis flip.
"""

from __future__ import annotations

import torch


def _apply44(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., N, 3) points."""
    T = T.to(points.dtype)
    out = (T[..., None, :3, :3] * points[..., None, :]).sum(dim=-1)
    return out + T[..., None, :3, 3]


def transform_pointcloud_to_world_frame(points: torch.Tensor,
                                        camera_pose: torch.Tensor
                                        ) -> torch.Tensor:
    """cam->world: x_w = T @ [x_c; 1]; ``camera_pose`` is the
    camera-to-world matrix ("world_matrix")."""
    return _apply44(camera_pose, points)


def affine_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) affine transforms (last row
    [0, 0, 0, 1]): adjugate 3x3 from cross products, then translation."""
    T = T.to(torch.float32)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    a, b, c = R[..., :, 0], R[..., :, 1], R[..., :, 2]  # columns
    r0 = torch.linalg.cross(b, c)
    r1 = torch.linalg.cross(c, a)
    r2 = torch.linalg.cross(a, b)
    det = (a * r0).sum(dim=-1, keepdim=True)[..., None]
    inv3 = torch.stack([r0, r1, r2], dim=-2) / det
    ti = -(inv3 * t[..., None, :]).sum(dim=-1)
    out = torch.zeros_like(T)
    out[..., :3, :3] = inv3
    out[..., :3, 3] = ti
    out[..., 3, 3] = 1.0
    return out


def transform_pointcloud_to_camera_frame(points: torch.Tensor,
                                         camera_pose: torch.Tensor
                                         ) -> torch.Tensor:
    """world->cam: x_c = T^-1 @ [x_w; 1]."""
    return _apply44(affine_inverse(camera_pose), points)


def flip_yz(points: torch.Tensor) -> torch.Tensor:
    """Negate y and z: the OpenGL/Blender <-> CV camera-axis flip."""
    return points * torch.tensor([1.0, -1.0, -1.0], dtype=points.dtype,
                                 device=points.device)
