"""Multi-scale dense RGB-D tracking (direct photometric + geometric alignment).

Port of `onepiece_tpu/odometry/dense.py` in the gather form of its
`dense_tracking_exact`: every Gauss-Newton iteration bilinearly samples the
target at the current pose. On the card each iteration is one kernel launch
that also solves and updates the pose (`ops/dense_odometry.gauss_newton`),
and one call per pyramid level enqueues all of that level's launches. The JAX package's production tracker pre-warps
bf16 quad rows and samples with stencils because a TPU gather is slow; a
GPU gathers natively, so the port keeps the exact form.

Convention: `T_ts` maps source-camera points into the target camera,
p_t = T_ts p_s, and a world pose chain updates as
T_w_target = T_w_source @ inv(T_ts).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..ops import dense_odometry as dops
from ..ops import image as image_ops

MIN_DEPTH = 0.5
MAX_DEPTH = 4.0
SOBEL_SCALE = 1.0 / 8.0
LAMBDA_HYBRID_DEPTH = 0.5
DEPTH_DIFF_MAX = 0.05  # max |warped z - sampled target z| in meters
DEFAULT_LEVELS = 3
DEFAULT_ITERS = (16, 8, 4)  # coarsest -> finest


class FramePyramid(NamedTuple):
    """Per-level preprocessed data for one RGB-D frame (finest level first)."""

    grays: tuple[torch.Tensor, ...]  # (H, W)
    depths: tuple[torch.Tensor, ...]  # (H, W) meters, 0 invalid
    xyzs: tuple[torch.Tensor, ...]  # (H, W, 3) camera-frame backprojections


class DenseTrackingResult(NamedTuple):
    T_ts: torch.Tensor  # (4, 4)
    cost: torch.Tensor
    num_inliers: torch.Tensor
    rmse: torch.Tensor


def _depth_pyr_down(depth: torch.Tensor) -> torch.Tensor:
    """Validity-aware 2x2 average: mean of nonzero depths, 0 if all invalid."""
    h, w = depth.shape
    d = depth[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    valid = (d > 0).to(depth.dtype)
    s = torch.sum(d * valid, dim=(1, 3))
    c = torch.sum(valid, dim=(1, 3))
    return torch.where(c > 0, s / torch.clamp(c, min=1.0), 0.0)


def preprocess_frame(
    gray: torch.Tensor,
    depth: torch.Tensor,
    camera: PinholeCamera,
    levels: int = DEFAULT_LEVELS,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
) -> FramePyramid:
    """Gray/depth -> pyramids + XYZ backprojections.

    Gaussian-smooths gray and depth; a pixel whose blur window touches an
    invalid depth is invalidated (validity erosion: the blurred validity
    mask must stay above 0.9999)."""
    g = image_ops.gaussian_blur(gray.to(torch.float32))
    d = image_ops.clip_depth(depth.to(torch.float32), min_depth, max_depth)
    vb = image_ops.gaussian_blur((d > 0).to(torch.float32))
    d = torch.where(vb > 0.9999, image_ops.gaussian_blur(d), 0.0)
    grays = [g]
    depths = [d]
    for _ in range(levels - 1):
        grays.append(image_ops.pyr_down(grays[-1]))
        depths.append(_depth_pyr_down(depths[-1]))
    cams = camera.pyramid(levels)
    xyzs = tuple(c.backproject_grid(dl) for c, dl in zip(cams, depths))
    return FramePyramid(tuple(grays), tuple(depths), xyzs)


def dense_tracking(
    source: FramePyramid,
    target: FramePyramid,
    camera: PinholeCamera,
    init_T: torch.Tensor | None = None,
    iters: tuple[int, ...] = DEFAULT_ITERS,
) -> DenseTrackingResult:
    """Coarse-to-fine Gauss-Newton alignment of source onto target.

    iters[0] applies to the coarsest level. Counterpart of the JAX
    package's `dense_tracking_exact` with its defaults: hybrid term, no
    Huber weights, pair_norm=False."""
    levels = len(source.grays)
    if len(iters) != levels:
        raise ValueError(f"{len(iters)} iteration counts for {levels} levels")
    dev = source.grays[0].device
    # the working pose, updated in place by every step; the caller's init_T
    # is never written
    if init_T is None:
        T = torch.eye(4, dtype=torch.float32, device=dev)
    else:
        T = init_T.clone(memory_format=torch.contiguous_format)
    cams = camera.pyramid(levels)
    for li in reversed(range(levels)):  # coarsest first
        tgt = dops.build_term_data(target.grays[li], target.depths[li], SOBEL_SCALE)
        cam = cams[li]
        ne = dops.gauss_newton(
            T, source.xyzs[li].reshape(-1, 3), source.grays[li].reshape(-1), tgt,
            cam.fx, cam.fy, cam.cx, cam.cy, LAMBDA_HYBRID_DEPTH, DEPTH_DIFF_MAX,
            iters[levels - 1 - li],
        )
    rmse = torch.sqrt(ne.cost / torch.clamp(ne.num_inliers, min=1.0))
    return DenseTrackingResult(T, ne.cost, ne.num_inliers, rmse)


def chain_pose(T_w_source: torch.Tensor, T_ts: torch.Tensor) -> torch.Tensor:
    """T_w_target = T_w_source @ inv(T_ts)."""
    return T_w_source @ se3.inverse_T(T_ts)
