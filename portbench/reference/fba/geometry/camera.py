"""Pinhole camera model. Port of `onepiece_tpu/geometry/camera.py`.

Frozen copy for the benchmark's reference: the plain version on every device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _recip(x: float) -> float:
    """The float32 reciprocal of a float32 constant, as a Python float."""
    return float(np.float32(1.0) / np.float32(x))


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

    def project(self, pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Camera-frame points (..., 3) -> pixel coords (..., 2) [u, v], depth (...,)."""
        z = pts[..., 2]
        zsafe = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
        u = pts[..., 0] / zsafe * self.fx + self.cx
        v = pts[..., 1] / zsafe * self.fy + self.cy
        return torch.stack([u, v], dim=-1), z

    def backproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) + depths (...,) -> camera-frame points (..., 3).
        Divides by fx and fy as a multiply by their float32 reciprocals, as
        XLA evaluates the JAX package's division by these jit constants."""
        x = (uv[..., 0] - self.cx) * _recip(self.fx) * depth
        y = (uv[..., 1] - self.cy) * _recip(self.fy) * depth
        return torch.stack([x, y, depth], dim=-1)

    def in_bounds(self, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
        """Mask (...,) of pixel coords inside the image with a border margin."""
        u, v = uv[..., 0], uv[..., 1]
        return (u >= margin) & (u <= self.width - 1 - margin) & (v >= margin) & (v <= self.height - 1 - margin)

    def intrinsic_matrix(self, device="cuda") -> torch.Tensor:
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
                            dtype=torch.float32, device=device)

    def backproject_grid(self, depth: torch.Tensor) -> torch.Tensor:
        """Depth image (H, W) -> camera-frame XYZ image (H, W, 3)."""
        h, w = depth.shape
        v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
        u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :].expand(h, w)
        x = (u - self.cx) / self.fx * depth
        y = (v - self.cy) / self.fy * depth
        return torch.stack([x, y, depth], dim=-1)


# The JAX package's preset intrinsics (distortion is ignored there too)
TUM_CAMERA = PinholeCamera(
    fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480, depth_scale=5000.0
)
OPEN3D_CAMERA = PinholeCamera(
    fx=514.817, fy=515.375, cx=318.771, cy=238.447, width=640, height=480, depth_scale=1000.0
)
MI_CAMERA = PinholeCamera(
    fx=2209.84366, fy=2210.23057, cx=756.24762, cy=530.00418, width=1440, height=1080, depth_scale=1000.0
)

PRESETS = {"tum": TUM_CAMERA, "open3d": OPEN3D_CAMERA, "mi": MI_CAMERA}
