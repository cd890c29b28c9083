"""Pixel-sharded dense odometry over the ranks of a `ShardGroup`.

Port of `onepiece_tpu/parallel/dense.py`. The source pixels of each pyramid
level are padded to a multiple of the world size (padding points have z = 0,
so they are never valid) and each rank takes one contiguous slice; the
target pyramid is replicated. Every Gauss-Newton iteration, each rank forms
the normal equations of its pixels (`ops/dense_odometry.normal_equations`:
the GN kernel with the update off on the card), one `psum` adds the 44
packed floats (JTJ, JTr, cost, inliers), and every rank solves the 6x6
system and updates its copy of the pose (`solve_and_update`). The
tracker is the exact gather form, as the JAX function's
`dops.normal_equations` is.
"""

from __future__ import annotations

import torch

from ..geometry.camera import PinholeCamera
from ..odometry import dense
from ..ops import dense_odometry as dops
from .comm import ShardGroup


def dense_tracking_sharded(
    group: ShardGroup,
    source: dense.FramePyramid,
    target: dense.FramePyramid,
    camera: PinholeCamera,
) -> dense.DenseTrackingResult:
    """Multi-scale dense tracking with the source pixels sharded over the
    group: the same math as `odometry/dense.dense_tracking` from the
    identity, the normal equations summed over the ranks. Every rank
    returns the same result."""
    levels = len(source.grays)
    cams = camera.pyramid(levels)
    T = torch.eye(4, dtype=torch.float32, device=source.grays[0].device)
    ne = None
    for li in reversed(range(levels)):  # coarsest first
        tgt = dops.build_term_data(target.grays[li], target.depths[li], dense.SOBEL_SCALE)
        pts = group.shard_rows(source.xyzs[li].reshape(-1, 3))
        gray = group.shard_rows(source.grays[li].reshape(-1))
        valid = pts[:, 2] > 0
        cam = cams[li]
        for _ in range(dense.DEFAULT_ITERS[levels - 1 - li]):
            part = dops.normal_equations(T, pts, gray, valid, tgt, cam.fx, cam.fy, cam.cx, cam.cy,
                                         dense.LAMBDA_HYBRID_DEPTH, dense.DEPTH_DIFF_MAX)
            full = group.psum(torch.cat([part.JTJ.reshape(36), part.JTr, part.cost[None], part.num_inliers[None]]))
            ne = dops.NormalEquations(full[:36].view(6, 6), full[36:42], full[42], full[43])
            T = dops.solve_and_update(T, ne)
    rmse = torch.sqrt(ne.cost / torch.clamp(ne.num_inliers, min=1.0))
    return dense.DenseTrackingResult(T, ne.cost, ne.num_inliers, rmse)
