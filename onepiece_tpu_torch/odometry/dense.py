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
from ..utils import tracing

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
    depth_blur: bool = True,
    intensity_norm: bool = False,
) -> FramePyramid:
    """Gray/depth -> pyramids + XYZ backprojections.

    Gaussian-smooths the gray image and, with `depth_blur`, the depth; a
    pixel whose depth blur window touches an invalid depth is invalidated
    (validity erosion: the blurred validity mask must stay above 0.9999).
    `intensity_norm` (the per-frame half of the reference's
    NormalizeIntensity, DenseOdometryFunction.cpp:129-144) scales the gray
    image so that its mean over the valid-depth pixels is 0.5."""
    with tracing.span("tracking.preprocess"):
        with tracing.span("tracking.smooth"):
            g = image_ops.gaussian_blur(gray.to(torch.float32))
            d = image_ops.clip_depth(depth.to(torch.float32), min_depth, max_depth)
            if depth_blur:
                vb = image_ops.gaussian_blur((d > 0).to(torch.float32))
                d = torch.where(vb > 0.9999, image_ops.gaussian_blur(d), 0.0)
            if intensity_norm:
                m = (d > 0).to(torch.float32)
                mean = torch.sum(g * m) / torch.clamp(torch.sum(m), min=1.0)
                g = g * (0.5 / torch.clamp(mean, min=1e-6))
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
    depth_diff_max: float = DEPTH_DIFF_MAX,
    pair_norm: bool = False,
) -> DenseTrackingResult:
    """Coarse-to-fine Gauss-Newton alignment of source onto target.

    iters[0] applies to the coarsest level. Counterpart of the JAX
    package's `dense_tracking_exact` with the hybrid term and no Huber
    weights. `pair_norm` is the reference's NormalizeIntensity
    (DenseOdometryFunction.cpp:129-144): over the identity-pose
    correspondences (both depths valid, |dz| < depth_diff_max) at the finest
    level, each image's scale to mean 0.5; at every level the source grays
    and the target's gray, dx and dy are scaled by these device scalars
    before the Gauss-Newton launches."""
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
    if pair_norm:
        ds, dt = source.depths[0], target.depths[0]
        m = ((ds > 0) & (dt > 0) & (torch.abs(dt - ds) < depth_diff_max)).to(torch.float32)
        msum = torch.clamp(torch.sum(m), min=1.0)
        s_s = 0.5 / torch.clamp(torch.sum(source.grays[0] * m) / msum, min=1e-6)
        s_t = 0.5 / torch.clamp(torch.sum(target.grays[0] * m) / msum, min=1e-6)
        # gray, dx, dy of the term data scaled; depth and its gradients kept
        t_scale = torch.cat([s_t.expand(3), torch.ones(5, device=dev)])
    for li in reversed(range(levels)):  # coarsest first
        with tracing.span("tracking.level", level=li):
            tgt = dops.build_term_data(target.grays[li], target.depths[li], SOBEL_SCALE)
            src_gray = source.grays[li]
            if pair_norm:
                tgt = dops.TermData(tgt.texels * t_scale)
                src_gray = src_gray * s_s
            cam = cams[li]
            ne = dops.gauss_newton(
                T, source.xyzs[li].reshape(-1, 3), src_gray.reshape(-1), tgt,
                cam.fx, cam.fy, cam.cx, cam.cy, LAMBDA_HYBRID_DEPTH, depth_diff_max,
                iters[levels - 1 - li],
            )
    rmse = torch.sqrt(ne.cost / torch.clamp(ne.num_inliers, min=1.0))
    return DenseTrackingResult(T, ne.cost, ne.num_inliers, rmse)


def chain_pose(T_w_source: torch.Tensor, T_ts: torch.Tensor) -> torch.Tensor:
    """T_w_target = T_w_source @ inv(T_ts)."""
    with tracing.span("tracking.chain"):
        return T_w_source @ se3.inverse_T(T_ts)
