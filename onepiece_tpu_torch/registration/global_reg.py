"""Global (feature-based) registration: FPFH matching + batched RANSAC.

Port of `onepiece_tpu/registration/global_reg.py`: voxel downsample ->
normals -> FPFH -> 1-NN feature match (33-d, `ops/knn.knn`) -> RanSaPC
rejection x3 -> rigid RANSAC over all hypotheses at once. The stages are
spans of the caller's layer: `.normals` and `.fpfh` in `extract_features`;
`.match`, `.ransapc` and RANSAC's own in `register`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from ..geometry.pointcloud import PointCloud, estimate_normals, voxel_downsample
from ..ops import knn as knn_ops
from ..ops import ransac
from ..utils import tracing
from . import fpfh as fpfh_mod

MIN_INLIERS = 30  # RANSAC inliers for a successful registration


@dataclasses.dataclass(frozen=True)
class RansacParams:
    voxel_size: float = 0.05
    normal_k: int = 16
    fpfh_radius: float = 0.25
    fpfh_k: int = 32
    threshold: float = 0.075
    num_hypotheses: int = 4096
    sample_size: int = 4
    ransapc_rounds: int = 3


class GlobalRegistrationResult(NamedTuple):
    T: torch.Tensor
    num_inliers: torch.Tensor
    rmse: torch.Tensor
    success: torch.Tensor


class CloudFeatures(NamedTuple):
    points: torch.Tensor  # (N, 3)
    normals: torch.Tensor
    valid: torch.Tensor
    fpfh: torch.Tensor  # (N, 33)


def downsample_and_extract(cloud: PointCloud, params: RansacParams = RansacParams()) -> CloudFeatures:
    return extract_features(voxel_downsample(cloud, params.voxel_size), params)


def extract_features(cloud: PointCloud, params: RansacParams = RansacParams()) -> CloudFeatures:
    """Normals + FPFH of an already-downsampled cloud."""
    ds = estimate_normals(cloud, k=params.normal_k)
    feats = fpfh_mod.compute_fpfh(ds.points, ds.normals, ds.valid, radius=params.fpfh_radius, k=params.fpfh_k)
    return CloudFeatures(ds.points, ds.normals, ds.valid, feats)


def register(
    src: CloudFeatures,
    tgt: CloudFeatures,
    params: RansacParams = RansacParams(),
    samples: Sequence[torch.Tensor] | None = None,
) -> GlobalRegistrationResult:
    """T mapping src points onto tgt. Draws from a generator seeded 0 on
    the points' device, anew on each call (the JAX package's default
    `PRNGKey(0)`). `samples`, if given, replaces every draw: the anchors of
    each RanSaPC round, then the hypotheses."""
    generator = torch.Generator(device=src.points.device).manual_seed(0)
    with tracing.span(".match"):
        idx = knn_ops.knn(src.fpfh, tgt.fpfh, tgt.valid, k=1)[0][:, 0]
        ok = src.valid & tgt.valid[idx]
        dst_pts = tgt.points[idx]
    with tracing.span(".ransapc"):
        for r in range(params.ransapc_rounds):
            ok = ransac.ransapc_filter(
                generator, src.points, dst_pts, ok, tolerance=params.voxel_size * 3.0,
                samples=None if samples is None else samples[r],
            )
    res = ransac.ransac_rigid(
        generator, src.points, dst_pts, ok,
        threshold=params.threshold, num_hypotheses=params.num_hypotheses,
        sample_size=params.sample_size, samples=None if samples is None else samples[-1],
    )
    return GlobalRegistrationResult(res.T, res.num_inliers, res.rmse, res.num_inliers >= MIN_INLIERS)
