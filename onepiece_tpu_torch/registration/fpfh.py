"""FPFH: 33-bin fast point feature histograms, batched over all points.

Port of `onepiece_tpu/registration/fpfh.py`. Neighbour sets come from the
brute-force radius k-NN (`ops/knn.radius_knn`); the Darboux-frame angles of
every (point, neighbour) pair and the three 11-bin histograms are computed
for all points at once.
"""

from __future__ import annotations

import math

import torch

from ..ops import knn as knn_ops
from ..utils import tracing

NUM_BINS = 11  # per angle feature -> 33-dim descriptor


def _pair_features(p1, n1, p2, n2):
    """Darboux-frame angles (alpha, phi, theta) of point pairs (..., 3)."""
    d = p2 - p1
    dist = torch.linalg.norm(d, dim=-1)
    du = d / torch.where(dist > 1e-9, dist, 1.0)[..., None]
    # order the pair so the source normal has the smaller angle to d
    a1 = torch.abs(torch.sum(n1 * du, dim=-1))
    a2 = torch.abs(torch.sum(n2 * du, dim=-1))
    swap = (a2 > a1)[..., None]
    ns = torch.where(swap, n2, n1)
    nt = torch.where(swap, n1, n2)
    du = torch.where(swap, -du, du)

    u = ns
    v = torch.linalg.cross(du, u)
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    v = v / torch.where(vn > 1e-9, vn, 1.0)
    w = torch.linalg.cross(u, v)
    alpha = torch.sum(v * nt, dim=-1)
    phi = torch.sum(u * du, dim=-1)
    theta = torch.atan2(torch.sum(w * nt, dim=-1), torch.sum(u * nt, dim=-1))
    return alpha, phi, theta


def _histogram(vals: torch.Tensor, lo: float, hi: float, w: torch.Tensor) -> torch.Tensor:
    """(N, K) values + (N, K) weights -> (N, NUM_BINS) weighted counts."""
    b = torch.clamp(((vals - lo) / (hi - lo) * NUM_BINS).to(torch.int64), 0, NUM_BINS - 1)
    out = torch.zeros((vals.shape[0], NUM_BINS), dtype=torch.float32, device=vals.device)
    return out.scatter_add_(1, b, w)


def compute_fpfh(
    points: torch.Tensor,  # (N, 3)
    normals: torch.Tensor,  # (N, 3)
    valid: torch.Tensor,  # (N,) bool
    radius: float = 0.25,
    k: int = 32,
) -> torch.Tensor:
    """(N, 33) FPFH descriptors; invalid points get zeros. A span `.fpfh`
    of the caller's layer."""
    with tracing.span(".fpfh"):
        idx, d2, in_r = knn_ops.radius_knn(points, points, valid, k=k, radius=radius)
        nb_ok = in_r & (d2 > 1e-12) & valid[:, None] & valid[idx]  # no self-pairs
        w = nb_ok.to(torch.float32)

        alpha, phi, theta = _pair_features(points[:, None, :], normals[:, None, :], points[idx], normals[idx])
        spfh = torch.cat([
            _histogram(alpha, -1.0, 1.0, w),
            _histogram(phi, -1.0, 1.0, w),
            _histogram(theta, -math.pi, math.pi, w),
        ], dim=-1)  # (N, 33)
        spfh = spfh / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)

        # FPFH = SPFH + mean over neighbours of SPFH(neighbour) / distance
        inv_d = torch.where(nb_ok, 1.0 / torch.sqrt(torch.clamp(d2, min=1e-12)), 0.0)
        agg = torch.einsum("nkf,nk->nf", spfh[idx], inv_d)
        ksum = torch.clamp(torch.sum(nb_ok, dim=-1, keepdim=True).to(torch.float32), min=1.0)
        fpfh = spfh + agg / ksum
        # each 11-bin block normalised to sum 100
        blocks = fpfh.reshape(-1, 3, NUM_BINS)
        s = torch.clamp(torch.sum(blocks, dim=-1, keepdim=True), min=1e-9)
        fpfh = (blocks / s * 100.0).reshape(-1, 3 * NUM_BINS)
        return torch.where(valid[:, None], fpfh, 0.0)
