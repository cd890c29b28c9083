"""Edge-sharded pose-graph Gauss-Newton over the ranks of a `ShardGroup`.

Port of `onepiece_tpu/parallel/posegraph.py`. The edges are split into one
contiguous slice per rank (`shard_edges`, padded with invalid edges); each
rank assembles its edges' dense (N, N, 6, 6) / (N, 6) normal equations
(`optimization/posegraph._assemble`); ONE `psum` adds H, b and the cost
over the ranks, and every rank solves the same damped system by Cholesky,
pose 0 held fixed (`optimization/posegraph._solve`, the serial step's).
Every rank holds the same sums, so every rank ends with bit-identical
poses. No kernel: the JAX package has none here.
"""

from __future__ import annotations

import torch

from ..optimization.posegraph import DEFAULT_ITERS, PoseGraphEdges, _assemble, _solve
from .comm import ShardGroup


def shard_edges(group: ShardGroup, edges: PoseGraphEdges) -> PoseGraphEdges:
    """This rank's edges: the edge axis padded (with invalid edges) to a
    multiple of the world size, then sliced."""
    return PoseGraphEdges(*(group.shard_rows(a) for a in edges))


def _gn_step_sharded(group: ShardGroup, poses: torch.Tensor, edges: PoseGraphEdges):
    n = poses.shape[0]
    H, b, cost = _assemble(poses, edges)
    # the collective: one psum of the assembled normal equations and the cost
    full = group.psum(torch.cat([H.reshape(-1), b.reshape(-1), cost[None]]))
    H = full[: n * n * 36].reshape(n, n, 6, 6)
    b = full[n * n * 36 : -1].reshape(n, 6)
    return _solve(poses, H, b), full[-1]


def optimize_pose_graph_sharded(
    group: ShardGroup,
    poses: torch.Tensor,  # (N, 4, 4) world-from-frame, replicated
    edges: PoseGraphEdges,  # this rank's edges (`shard_edges`)
    iters: int = DEFAULT_ITERS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Edge-sharded pose-graph GN; returns (optimised poses, final cost),
    the same on every rank."""
    cost = torch.zeros((), dtype=torch.float32, device=poses.device)
    for _ in range(iters):
        poses, cost = _gn_step_sharded(group, poses, edges)
    return poses, cost
