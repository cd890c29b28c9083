"""Point-sharded bundle adjustment: the Schur reduction summed over the ranks.

Port of `onepiece_tpu/parallel/ba.py`. The points are split into one
contiguous slice per rank, each with all its observations (the per-point
(P, Omax) layout of `per_point_layout`), so V, V^-1 and the point
back-substitution are local to the rank. Each rank flattens its slice into
the port's observation lists and runs the BA Schur kernel's reduction
(`ops/ba_schur.reduced_system`, the kernel of `csrc/ba_schur.cu` on the
card) with `undamped_u`: S = U - W damp(V)^-1 W^T, rhs_c = b_c - W
damp(V)^-1 b_p and U's blocks. One `psum` adds S, rhs_c, U and the cost;
U is damped once, after the sum (the JAX function damps after its psum),
by adding damp(U)'s diagonal terms to S. Every rank solves the same
system by Cholesky with pose 0 fixed, and back-substitutes its own points
(`ops/ba_schur.back_substitute`, the kernel's third launch on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3
from ..ops import ba_schur
from .comm import ShardGroup


def per_point_layout(obs, num_points: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat observations (`optimization/bundle.BAObservations`) -> per-point
    (P, Omax) host arrays: frame index (int64), uv (float32), mask (bool)."""
    lists = np.asarray(obs.obs_of_point)[:num_points]
    mask = lists >= 0
    frame = np.asarray(obs.frame)
    safe = np.clip(lists, 0, max(len(frame) - 1, 0))
    frame_pp = np.where(mask, frame[safe], 0).astype(np.int64)
    uv_pp = np.where(mask[..., None], np.asarray(obs.uv)[safe], 0.0).astype(np.float32)
    return frame_pp, uv_pp, mask


def _flatten(frame_pp: torch.Tensor, uv_pp: torch.Tensor, mask_pp: torch.Tensor):
    """(Ps, Omax) -> the valid observations as lists: frame, point, uv."""
    ps, omax = frame_pp.shape
    keep = mask_pp.reshape(-1)
    point = torch.arange(ps, device=frame_pp.device).repeat_interleave(omax)
    return frame_pp.reshape(-1)[keep], point[keep], uv_pp.reshape(-1, 2)[keep]


def distributed_ba_step(
    group: ShardGroup,
    poses: torch.Tensor,  # (F, 4, 4) T_cw, replicated
    points: torch.Tensor,  # (Ps, 3) this rank's points
    frame_pp: torch.Tensor,  # (Ps, Omax) int64
    uv_pp: torch.Tensor,  # (Ps, Omax, 2)
    mask_pp: torch.Tensor,  # (Ps, Omax) bool
    lam: float = 1e-4,
    fx: float = 300.0, fy: float = 300.0, cx: float = 160.0, cy: float = 120.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One damped step of the 2-D reprojection model, the reduced system
    summed over the ranks. Returns (new poses (F, 4, 4), the same on every
    rank; this rank's new points (Ps, 3); the total cost sum w |r|^2). On
    the CPU the step follows the inputs' dtype (float64 too); the kernel
    takes float32."""
    F, dev, dt = poses.shape[0], poses.device, poses.dtype
    frame, point, uv = _flatten(frame_pp, uv_pp, mask_pp)
    valid = torch.ones(frame.shape, dtype=torch.bool, device=dev)
    lam_t = torch.full((), lam, dtype=dt, device=dev)
    lists = ba_schur.build_lists(frame, point, valid, F, points.shape[0]) if poses.is_cuda else None
    system = ba_schur.reduced_system(poses, points, frame, point, uv, valid, lam_t, (fx, fy, cx, cy),
                                     lists=lists, undamped_u=True)
    r, _, _, w = ba_schur.residuals_jacobians_2d(poses, points, frame, point, uv, valid, fx, fy, cx, cy)
    cost = torch.sum(w * torch.sum(r * r, -1))
    # the collective: S, rhs_c, U and the cost in one psum
    n6 = 6 * F
    full = group.psum(torch.cat([system.S.reshape(-1), system.rhs_c, system.U.reshape(-1), cost[None]]))
    S = full[: n6 * n6].reshape(n6, n6)
    rhs = full[n6 * n6 : n6 * n6 + n6]
    U = full[n6 * n6 + n6 : -1].reshape(F, 6, 6)
    # damp U once, after the sum: S's diagonal gains damp(U)'s additions
    diag = torch.diagonal(U, dim1=1, dim2=2)  # (F, 6)
    S = S + torch.diag((lam_t * torch.abs(diag) + (1e-6 * (diag.sum(1, keepdim=True) / 6.0) + 1e-9)).reshape(-1))
    L, info = torch.linalg.cholesky_ex(S[6:, 6:] + 1e-9 * torch.eye(n6 - 6, dtype=dt, device=dev))
    dc = torch.cholesky_solve(-rhs[6:, None], L)[:, 0]
    ok = torch.isfinite(dc).all() & (info == 0)
    dc = torch.cat([torch.zeros(6, dtype=dt, device=dev), torch.where(ok, dc, 0.0)])
    new_poses = se3.se3_exp(dc.reshape(F, 6)) @ poses
    dp = ba_schur.back_substitute(system, dc, frame, point, lists)
    return new_poses, points + torch.where(ok, dp, 0.0), full[-1]
