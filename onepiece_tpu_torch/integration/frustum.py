"""Camera view frustum: plane extraction and containment tests.

Port of `onepiece_tpu/integration/frustum.py` (ref: src/Integration/Frustum.
{h,cpp}: `ComputeFromCamera` :7-25, `ComputeFromVectors` :26-60,
`ContainPoint` Frustum.h:74-103). Containment is a batched half-space test.
"""

from __future__ import annotations

import torch

from ..geometry.camera import PinholeCamera


def frustum_planes(camera: PinholeCamera, T_wc: torch.Tensor, near: float = 0.1, far: float = 8.0) -> torch.Tensor:
    """(6, 4) inward-facing planes [n | d] in world coordinates (n.x + d >= 0
    inside) of a camera at T_wc (camera-to-world): four sides through the
    corner pixels' rays, then the near and far planes."""
    c = camera
    corners = torch.tensor([
        [(0 - c.cx) / c.fx, (0 - c.cy) / c.fy, 1.0],
        [(c.width - 1 - c.cx) / c.fx, (0 - c.cy) / c.fy, 1.0],
        [(c.width - 1 - c.cx) / c.fx, (c.height - 1 - c.cy) / c.fy, 1.0],
        [(0 - c.cx) / c.fx, (c.height - 1 - c.cy) / c.fy, 1.0],
    ], dtype=torch.float32).to(T_wc.device)
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    rays = corners @ R.T  # world-frame corner directions
    fwd = R[:, 2]
    planes = []
    for i in range(4):
        # the cross of adjacent corner rays, turned so the centre ray is inside
        n = torch.linalg.cross(rays[i], rays[(i + 1) % 4])
        n = n / torch.clamp(torch.linalg.vector_norm(n), min=1e-9)
        n = torch.where(torch.dot(n, fwd) < 0, -n, n)
        planes.append(torch.cat([n, -torch.dot(n, t)[None]]))
    planes.append(torch.cat([fwd, -torch.dot(fwd, t + near * fwd)[None]]))
    planes.append(torch.cat([-fwd, torch.dot(fwd, t + far * fwd)[None]]))
    return torch.stack(planes)


def contains(planes: torch.Tensor, points: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """(6, 4) planes x (..., 3) points -> (...,) bool: inside the frustum."""
    d = torch.einsum("pi,...i->...p", planes[:, :3], points) + planes[:, 3]
    return torch.all(d >= -margin, dim=-1)
