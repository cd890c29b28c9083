"""Point clouds as fixed-capacity tensors with a validity mask.

Port of `onepiece_tpu/geometry/pointcloud.py`. A cloud is a bundle of
(C, 3) tensors and a (C,) bool mask on one device; invalid entries are
padding. Capacities are bucketed (next power of two from 1024), as in the
JAX package, so the submap clouds of a run come in a few sizes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import knn as knn_ops
from ..utils import tracing
from . import se3, transforms

_KEY_PAD = torch.iinfo(torch.int32).max  # key of an invalid point: sorts last


def _next_capacity(n: int) -> int:
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """points / normals / colors: (C, 3) float32; valid: (C,) bool."""

    points: torch.Tensor
    normals: torch.Tensor
    colors: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid)

    @staticmethod
    def from_numpy(
        points: np.ndarray,
        normals: np.ndarray | None = None,
        colors: np.ndarray | None = None,
        capacity: int | None = None,
        device: str | torch.device = "cpu",
    ) -> "PointCloud":
        n = points.shape[0]
        cap = capacity or _next_capacity(n)
        arrays = []
        for a in (points, normals, colors):
            out = np.zeros((cap, 3), np.float32)
            if a is not None:
                out[:n] = a
            arrays.append(torch.from_numpy(out).to(device))
        valid = torch.zeros(cap, dtype=torch.bool, device=device)
        valid[:n] = True
        return PointCloud(*arrays, valid)

    @staticmethod
    def from_rgbd(depth: torch.Tensor, rgb: torch.Tensor | None, camera, depth_min: float = 0.05,
                  depth_max: float = 10.0) -> "PointCloud":
        """Back-project a depth image, with its (H, W, 3) colours if `rgb` is
        given (else black), into a camera-frame cloud of capacity H*W;
        depths outside (depth_min, depth_max) stay as masked entries."""
        pts = camera.backproject_grid(depth).reshape(-1, 3)
        valid = ((depth > depth_min) & (depth < depth_max) & torch.isfinite(depth)).reshape(-1)
        col = torch.zeros_like(pts) if rgb is None else rgb.reshape(-1, 3).to(torch.float32)
        return PointCloud(pts, torch.zeros_like(pts), col, valid)

    def transform(self, T: torch.Tensor) -> "PointCloud":
        return dataclasses.replace(
            self,
            points=se3.transform_points(T, self.points),
            normals=se3.transform_normals(T, self.normals),
        )

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The valid entries as host arrays (points, normals, colors)."""
        v = self.valid.cpu().numpy()
        return tuple(x.cpu().numpy()[v] for x in (self.points, self.normals, self.colors))


def compact(cloud: PointCloud) -> PointCloud:
    """Move the valid points to the front and shrink the capacity to the
    next bucket. The host needs the count for the new capacity: one sync;
    the gather stays on the device."""
    with tracing.sync("submap_compact"):
        keep = torch.nonzero(cloud.valid)[:, 0]  # the valid entries, in order
    n = keep.shape[0]
    cap = _next_capacity(n)
    fields = []
    for x in (cloud.points, cloud.normals, cloud.colors):
        out = torch.zeros((cap, 3), dtype=torch.float32, device=x.device)
        out[:n] = x[keep]
        fields.append(out)
    return PointCloud(*fields, torch.arange(cap, device=cloud.device) < n)


def merge(*clouds: PointCloud) -> PointCloud:
    """Concatenate clouds in order. Takes any number, so a list merges in
    one copy where pairwise merges would copy the growing prefix again for
    every cloud."""
    return PointCloud(*(torch.cat([getattr(c, f.name) for c in clouds])
                        for f in dataclasses.fields(PointCloud)))


def _voxel_keys(pts: torch.Tensor, valid: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """int32 voxel key per point: 3 x 10 bits of floor(p / voxel) + 512,
    clipped to [0, 1023]; invalid points get the int32 maximum (sort last)."""
    off = torch.clamp(torch.floor(pts / voxel_size).to(torch.int32) + 512, 0, 1023)
    key = (off[:, 0] << 20) | (off[:, 1] << 10) | off[:, 2]
    return torch.where(valid, key, _KEY_PAD)


def voxel_downsample(cloud: PointCloud, voxel_size: float) -> PointCloud:
    """Voxel-grid average: one averaged point (and normal, colour) per
    occupied voxel, in key order at the front of a cloud of the input's
    capacity. A stable sort of the keys, then segment sums in point order
    (`segment_reduce`: the same sums on every run and on every device, where
    `index_add_`'s float atomics on the card add in another order each
    run); no host round trip."""
    cap = cloud.capacity
    dev = cloud.device
    key = _voxel_keys(cloud.points, cloud.valid, voxel_size)
    key_s, order = torch.sort(key, stable=True)
    seg_start = torch.ones_like(key_s, dtype=torch.bool)
    seg_start[1:] = key_s[1:] != key_s[:-1]
    seg_id = (torch.cumsum(seg_start.to(torch.int32), 0) - 1).to(torch.int64)
    # points per segment, 0 past the last: integer sums, exact in any order
    lengths = torch.zeros(cap, dtype=torch.int64, device=dev).index_add_(0, seg_id, torch.ones_like(seg_id))
    cnt = torch.clamp(lengths[:, None].to(torch.float32), min=1.0)
    # lengths sum to cap and none is negative, so the checks (host syncs) are skipped
    fields = torch.cat([cloud.points, cloud.normals, cloud.colors], 1)[order]
    sums = torch.segment_reduce(fields, "sum", lengths=lengths, axis=0, unsafe=True)
    new_pts, new_nrm, new_col = (x.contiguous() for x in (sums / cnt).split(3, 1))
    nnorm = torch.linalg.norm(new_nrm, dim=-1, keepdim=True)
    new_nrm = torch.where(nnorm > 1e-9, new_nrm / torch.clamp(nnorm, min=1e-9), new_nrm)
    num_segs = torch.sum(seg_start & (key_s < _KEY_PAD))
    new_valid = torch.arange(cap, device=dev) < num_segs
    return PointCloud(new_pts, new_nrm, new_col, new_valid)


def estimate_normals(cloud: PointCloud, k: int = 16) -> PointCloud:
    """Normals from the k nearest neighbours (smallest covariance
    eigenvector), oriented towards the origin (the viewpoint). A span
    `.normals` of the caller's layer."""
    with tracing.span(".normals"):
        idx = knn_ops.knn(cloud.points, cloud.points, cloud.valid, k=k)[0]
        normals = transforms.estimate_normals_from_neighbors(cloud.points[idx], cloud.valid[idx])
        flip = torch.sum(normals * cloud.points, dim=-1) > 0.0
        normals = torch.where(flip[:, None], -normals, normals)
        normals = torch.where(cloud.valid[:, None], normals, 0.0)
        return dataclasses.replace(cloud, normals=normals)
