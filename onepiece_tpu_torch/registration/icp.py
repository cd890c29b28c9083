"""Iterative closest point: point-to-point and point-to-plane.

Port of `onepiece_tpu/registration/icp.py`. Each iteration finds every
source point's nearest valid target point (`ops/nn1.nn1`: the CUDA kernel
on the card), keeps the pairs closer than `threshold`, and re-estimates the
pose: weighted Kabsch (point-to-point) or one 6x6 Gauss-Newton step on
n . (T p - q) (point-to-plane). A fixed number of iterations runs, then one
more correspondence pass scores the result: `iters + 1` nn1 launches per
call. A degenerate step keeps the previous pose, decided on the device.
While a profiler records, each iteration counts under `icp.iter`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3, transforms
from ..ops import nn1 as nn1_ops
from ..utils import tracing

DEFAULT_ITERS = 30
DEFAULT_THRESHOLD = 0.1  # inlier distance (metres)


class ICPResult(NamedTuple):
    T: torch.Tensor  # (4, 4) aligning source onto target
    num_inliers: torch.Tensor  # () int64
    rmse: torch.Tensor  # ()


def _correspond(src_t, src_valid, tgt, tgt_valid, threshold):
    idx, d2 = nn1_ops.nn1(src_t, tgt, tgt_valid)
    ok = src_valid & (d2 < threshold * threshold)
    return idx.long(), d2, ok


def _apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ T[:3, :3].T + T[:3, 3]


def _initial_pose(init_T, like: torch.Tensor) -> torch.Tensor:
    if init_T is None:
        return torch.eye(4, dtype=torch.float32, device=like.device)
    return init_T.to(device=like.device, dtype=torch.float32)


def point_to_point(
    src: torch.Tensor,  # (N, 3)
    src_valid: torch.Tensor,  # (N,) bool
    tgt: torch.Tensor,  # (M, 3)
    tgt_valid: torch.Tensor,  # (M,) bool
    init_T: torch.Tensor | None = None,
    threshold: float = DEFAULT_THRESHOLD,
    iters: int = DEFAULT_ITERS,
) -> ICPResult:
    T = _initial_pose(init_T, src)
    for _ in range(iters):
        tracing.count("icp.iter")
        idx, _, ok = _correspond(_apply(T, src), src_valid, tgt, tgt_valid, threshold)
        w = ok.to(torch.float32)
        T_new = transforms.kabsch(src, tgt[idx], w)
        good = torch.isfinite(T_new).all() & (torch.sum(w) > 3)
        T = torch.where(good, T_new, T)
    _, d2, ok = _correspond(_apply(T, src), src_valid, tgt, tgt_valid, threshold)
    n = torch.sum(ok)
    rmse = torch.sqrt(torch.sum(torch.where(ok, d2, 0.0)) / torch.clamp(n, min=1))
    return ICPResult(T, n, rmse)


def point_to_plane(
    src: torch.Tensor,
    src_valid: torch.Tensor,
    tgt: torch.Tensor,
    tgt_normals: torch.Tensor,
    tgt_valid: torch.Tensor,
    init_T: torch.Tensor | None = None,
    threshold: float = DEFAULT_THRESHOLD,
    iters: int = DEFAULT_ITERS,
) -> ICPResult:
    T = _initial_pose(init_T, src)
    eye6 = torch.eye(6, dtype=torch.float32, device=src.device)
    for _ in range(iters):
        tracing.count("icp.iter")
        src_t = _apply(T, src)
        idx, _, ok = _correspond(src_t, src_valid, tgt, tgt_valid, threshold)
        q, n = tgt[idx], tgt_normals[idx]
        w = ok.to(torch.float32)
        r = torch.sum(n * (src_t - q), dim=-1)
        # J = [n | src_t x n] for the left-multiplied twist of T
        J = torch.cat([n, torch.linalg.cross(src_t, n)], dim=-1)
        JTJ = torch.einsum("ni,n,nj->ij", J, w, J)
        JTr = torch.einsum("ni,n,n->i", J, w, r)
        xi, info = torch.linalg.solve_ex(JTJ + 1e-8 * eye6, -JTr)
        good = torch.isfinite(xi).all() & (torch.sum(w) > 6) & (info == 0)
        T = se3.se3_exp(torch.where(good, xi, 0.0)) @ T
    src_t = _apply(T, src)
    idx, _, ok = _correspond(src_t, src_valid, tgt, tgt_valid, threshold)
    r = torch.sum(tgt_normals[idx] * (src_t - tgt[idx]), dim=-1)
    ni = torch.sum(ok)
    rmse = torch.sqrt(torch.sum(torch.where(ok, r * r, 0.0)) / torch.clamp(ni, min=1))
    return ICPResult(T, ni, rmse)
