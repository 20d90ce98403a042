"""SE(3) transforms for point clouds and poses, and 2D coordinate
scaling between image, crop and patch grids.

Port of ``dropclip_tpu/geom/transforms.py`` (reference
utils/transforms.py:43-146): 4x4 transforms applied as a broadcast
multiply-sum over leading batch axes (float32 throughout, whatever the
card's TF32 setting), the closed-form affine inverse, the camera-axis
flip, and ``CoordTransform2d``.
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


def _compose44(A: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """A (4, 4) @ each of (N, 4, 4) poses, as a broadcast multiply-sum."""
    A = A.to(torch.float32)
    return (A[None, :, :, None] * poses.to(torch.float32)[:, None, :, :]
            ).sum(dim=-2)


def transform_poses_to_camera_frame(poses: torch.Tensor,
                                    camera_pose: torch.Tensor
                                    ) -> torch.Tensor:
    """(N, 4, 4) poses world -> cam: T^-1 @ P (reference
    utils/transforms.py:64-80)."""
    return _compose44(affine_inverse(camera_pose), poses)


def transform_poses_to_world_frame(poses: torch.Tensor,
                                   camera_pose: torch.Tensor
                                   ) -> torch.Tensor:
    """(N, 4, 4) poses cam -> world: T @ P (reference
    utils/transforms.py:83-96)."""
    return _compose44(camera_pose, poses)


def flip_yz(points: torch.Tensor) -> torch.Tensor:
    """Negate y and z: the OpenGL/Blender <-> CV camera-axis flip."""
    return points * torch.tensor([1.0, -1.0, -1.0], dtype=points.dtype,
                                 device=points.device)


class CoordTransform2d:
    """Scale (x, y) between image, crop and patch coordinate grids
    (reference utils/transforms.py:99-146). The scaled values are rounded
    to float32 and truncated toward zero to int32, as the JAX package's
    ``.astype(int32)`` does."""

    def __init__(self, img_dim, patch_size, resize_dim=None):
        self.height, self.width = img_dim
        self.crop_size = resize_dim or img_dim
        self.patch_size = patch_size
        self.patch_h = self.crop_size[0] / patch_size
        self.patch_w = self.crop_size[1] / patch_size

    @staticmethod
    def _transform(x, y, scale_h, scale_w):
        cast = lambda v: torch.as_tensor(v).to(torch.float32).to(torch.int32)
        return cast(x * scale_w), cast(y * scale_h)

    def img_to_patch(self, x, y):
        return self._transform(x, y, self.patch_h / self.height,
                               self.patch_w / self.width)

    def patch_to_img(self, x, y):
        return self._transform(x, y, self.height / self.patch_h,
                               self.width / self.patch_w)

    def crop_to_patch(self, x, y):
        return self._transform(x, y, self.patch_h / self.crop_size[0],
                               self.patch_w / self.crop_size[1])

    def patch_to_crop(self, x, y):
        return self._transform(x, y, self.crop_size[0] / self.patch_h,
                               self.crop_size[1] / self.patch_w)

    def img_to_crop(self, x, y):
        return self._transform(x, y, self.crop_size[0] / self.height,
                               self.crop_size[1] / self.width)

    def crop_to_img(self, x, y):
        return self._transform(x, y, self.height / self.crop_size[0],
                               self.width / self.crop_size[1])
