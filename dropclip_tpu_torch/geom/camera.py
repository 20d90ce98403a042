"""Pinhole camera model (reference utils/projections.py:16-37).

Port of ``dropclip_tpu/geom/camera.py``: a small value object whose
``K`` is a float32 tensor on ``device`` (the CPU unless given).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict

import torch


@dataclass(frozen=True)
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480
    device: str = field(default="cpu", compare=False)

    @property
    def K(self) -> torch.Tensor:
        return torch.tensor([[self.fx, 0.0, self.cx],
                             [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32,
                            device=self.device)

    @classmethod
    def from_dict(cls, d: Dict[str, float], width: int = 640,
                  height: int = 480, device: str = "cpu"
                  ) -> "CameraIntrinsics":
        return cls(fx=float(d["fx"]), fy=float(d["fy"]), cx=float(d["cx"]),
                   cy=float(d["cy"]), width=width, height=height,
                   device=device)

    @classmethod
    def mvtod(cls, base_scale: float = 10.0, device: str = "cpu"
              ) -> "CameraIntrinsics":
        """MV-TOD / Blender intrinsics: fx = fy = 444.44 * (base_scale /
        10), 640x480 (reference data/blender.py:180-187)."""
        f = 444.44444444 * (base_scale / 10.0)
        return cls(fx=f, fy=f, cx=319.5, cy=239.5, width=640, height=480,
                   device=device)

    def scale(self, sx: float, sy: float) -> "CameraIntrinsics":
        return replace(self, fx=self.fx * sx, fy=self.fy * sy,
                       cx=self.cx * sx, cy=self.cy * sy,
                       width=int(round(self.width * sx)),
                       height=int(round(self.height * sy)))
