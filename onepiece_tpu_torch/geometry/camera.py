"""Pinhole camera model. Port of `onepiece_tpu/geometry/camera.py`."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Intrinsics (plain Python numbers; hashable, so usable as a cache key)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    depth_scale: float

    def next_pyramid_level(self) -> "PinholeCamera":
        """Camera of the half-resolution pyramid level: intrinsics halve and
        the principal point follows the pyrDown grid, (c + 0.5) / 2 - 0.5."""
        return PinholeCamera(
            fx=self.fx * 0.5,
            fy=self.fy * 0.5,
            cx=(self.cx + 0.5) * 0.5 - 0.5,
            cy=(self.cy + 0.5) * 0.5 - 0.5,
            width=self.width // 2,
            height=self.height // 2,
            depth_scale=self.depth_scale,
        )

    def pyramid(self, levels: int) -> tuple["PinholeCamera", ...]:
        cams = [self]
        for _ in range(levels - 1):
            cams.append(cams[-1].next_pyramid_level())
        return tuple(cams)

    def backproject_grid(self, depth: torch.Tensor) -> torch.Tensor:
        """Depth image (H, W) -> camera-frame XYZ image (H, W, 3)."""
        h, w = depth.shape
        v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
        u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :].expand(h, w)
        x = (u - self.cx) / self.fx * depth
        y = (v - self.cy) / self.fy * depth
        return torch.stack([x, y, depth], dim=-1)


# TUM fr1 intrinsics (the JAX package's preset; distortion is ignored there too)
TUM_CAMERA = PinholeCamera(
    fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480, depth_scale=5000.0
)
