"""Exact k-nearest-neighbour search by brute force, tiled over the queries.

Port of `onepiece_tpu/ops/knn.py`. Distances use the expansion
|a - b|^2 = |a|^2 + |b|^2 - 2 a.b, so the inner loop is one matrix product
per query tile. This is plain PyTorch on every device: the JAX package left
it to XLA (it is not a Pallas kernel). The 3-d 1-NN that ICP runs every
iteration has its own kernel, `ops/nn1.py`.
"""

from __future__ import annotations

import torch

LARGE = 1e30
TILE = 2048  # query rows per (tile, M) distance block


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 over the last axis as a chain of fused multiply-adds,
    t <- fma(x_i, x_i, t), the way XLA's CPU backend reduces it. Each step
    is exact in float64 (a float32 square has 48 significant bits) before
    it rounds to float32. The expansion form cancels, so its distances are
    only as good as these norms: matching them keeps near-neighbour
    distances (and FPFH's 1/d weights) equal to the JAX package's."""
    x64 = x.to(torch.float64)
    t = (x64[..., 0] * x64[..., 0]).to(torch.float32)
    for i in range(1, x.shape[-1]):
        t = (x64[..., i] * x64[..., i] + t).to(torch.float32)
    return t


def pairwise_sqdist(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (N, D) x (M, D) -> (N, M), clamped at 0."""
    cross = query @ ref.T
    return torch.clamp(_sqnorm(query)[:, None] + _sqnorm(ref)[None, :] - 2.0 * cross, min=0.0)


def knn(
    query: torch.Tensor,  # (N, D)
    ref: torch.Tensor,  # (M, D)
    ref_valid: torch.Tensor,  # (M,) bool
    k: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: (indices (N, k) int64, squared distances (N, k)), nearest
    first. Invalid reference points never match: their distance is LARGE."""
    idx_out, d_out = [], []
    for q in torch.split(query, TILE):
        d = torch.where(ref_valid[None, :], pairwise_sqdist(q, ref), LARGE)
        if k == 1:
            idx = torch.argmin(d, dim=-1, keepdim=True)
            dist = torch.gather(d, 1, idx)
        else:
            dist, idx = torch.topk(d, k, dim=-1, largest=False)
        idx_out.append(idx)
        d_out.append(dist)
    return torch.cat(idx_out), torch.cat(d_out)


def radius_knn(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_valid: torch.Tensor,
    k: int,
    radius: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest neighbours within `radius`: (indices (N, k), squared
    distances (N, k), in-radius mask (N, k))."""
    idx, dist = knn(query, ref, ref_valid, k=k)
    return idx, dist, dist <= radius * radius
