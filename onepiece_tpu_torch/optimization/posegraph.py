"""Pose-graph Gauss-Newton over 3D-3D correspondence edges.

Port of `onepiece_tpu/optimization/posegraph.py`. For an edge (s, t) with
correspondence pairs (p in frame s, q in frame t):

    r = T_s p - T_t q                     (world-frame 3-vector)
    J wrt the left twist of T_s:  [ I | -[T_s p]_x ]
    J wrt the left twist of T_t: -[ I | -[T_t q]_x ]

All edge blocks are computed at once and accumulated into a dense
(N, N, 6, 6) block matrix; pose 0 is held fixed (gauge), and the damped
system is solved by Cholesky.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3

DEFAULT_ITERS = 5
DAMPING = 1e-6  # added to the diagonal of the reduced system


class PoseGraphEdges(NamedTuple):
    """Padded edge tensors."""

    src: torch.Tensor  # (E,) int64 source pose index
    dst: torch.Tensor  # (E,) int64 target pose index
    p_src: torch.Tensor  # (E, C, 3) points in source-frame coords
    p_dst: torch.Tensor  # (E, C, 3) matched points in target-frame coords
    valid: torch.Tensor  # (E, C) bool
    edge_valid: torch.Tensor  # (E,) bool


def _edge_blocks(T_src, T_dst, p_src, p_dst, valid):
    """Per-edge 6x6 blocks and right-hand sides, batched over edges:
    T (E, 4, 4), p (E, C, 3), valid (E, C)."""
    pw = p_src @ T_src[:, :3, :3].transpose(-1, -2) + T_src[:, None, :3, 3]
    qw = p_dst @ T_dst[:, :3, :3].transpose(-1, -2) + T_dst[:, None, :3, 3]
    r = pw - qw  # (E, C, 3)
    w = valid.to(torch.float32)
    eye = torch.eye(3, dtype=pw.dtype, device=pw.device).expand(pw.shape[:-1] + (3, 3))
    Js = torch.cat([eye, -se3.skew(pw)], dim=-1)  # (E, C, 3, 6)
    Jt = -torch.cat([eye, -se3.skew(qw)], dim=-1)
    Hss = torch.einsum("ecki,ec,eckj->eij", Js, w, Js)
    Htt = torch.einsum("ecki,ec,eckj->eij", Jt, w, Jt)
    Hst = torch.einsum("ecki,ec,eckj->eij", Js, w, Jt)
    bs = torch.einsum("ecki,ec,eck->ei", Js, w, r)
    bt = torch.einsum("ecki,ec,eck->ei", Jt, w, r)
    cost = torch.einsum("ec,eck->e", w, r * r)
    return Hss, Htt, Hst, bs, bt, cost


def _assemble(poses: torch.Tensor, edges: PoseGraphEdges):
    """The normal equations of `edges`: (H (N, N, 6, 6), b (N, 6), cost)."""
    n = poses.shape[0]
    dev = poses.device
    ev = edges.edge_valid[:, None] & edges.valid
    Hss, Htt, Hst, bs, bt, cost = _edge_blocks(
        poses[edges.src], poses[edges.dst], edges.p_src, edges.p_dst, ev)
    # accumulate=True: edges that share a pose (or a pose pair) all add up,
    # where advanced-index `+=` would keep only one of the duplicates
    H = torch.zeros((n, n, 6, 6), dtype=torch.float32, device=dev)
    H.index_put_((edges.src, edges.src), Hss, accumulate=True)
    H.index_put_((edges.dst, edges.dst), Htt, accumulate=True)
    H.index_put_((edges.src, edges.dst), Hst, accumulate=True)
    H.index_put_((edges.dst, edges.src), Hst.transpose(-1, -2), accumulate=True)
    b = torch.zeros((n, 6), dtype=torch.float32, device=dev)
    b.index_put_((edges.src,), bs, accumulate=True)
    b.index_put_((edges.dst,), bt, accumulate=True)
    return H, b, torch.sum(cost)


def _solve(poses: torch.Tensor, H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The poses after the damped step of the normal equations (H, b)."""
    n = poses.shape[0]
    dev = poses.device
    Hd = H.permute(0, 2, 1, 3).reshape(n * 6, n * 6)
    # gauge fix: pose 0 stays where it is
    A = Hd[6:, 6:] + DAMPING * torch.eye(6 * (n - 1), dtype=torch.float32, device=dev)
    rhs = -b.reshape(n * 6)[6:]
    # cholesky_ex reports a matrix that is not positive definite in `info`
    # instead of raising; the step is then skipped, as a NaN solve is in JAX
    L, info = torch.linalg.cholesky_ex(A)
    delta = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    ok = torch.isfinite(delta).all() & (info == 0)
    delta = torch.where(ok, delta, 0.0)
    xi = torch.cat([torch.zeros((1, 6), dtype=torch.float32, device=dev), delta.reshape(n - 1, 6)])
    return se3.se3_exp(xi) @ poses


def _gn_step(poses: torch.Tensor, edges: PoseGraphEdges):
    H, b, cost = _assemble(poses, edges)
    return _solve(poses, H, b), cost


def optimize_pose_graph(
    poses: torch.Tensor,  # (N, 4, 4) world-from-frame
    edges: PoseGraphEdges,
    iters: int = DEFAULT_ITERS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run `iters` Gauss-Newton steps; returns (optimised poses, final cost)."""
    cost = torch.zeros((), dtype=torch.float32, device=poses.device)
    for _ in range(iters):
        poses, cost = _gn_step(poses, edges)
    return poses, cost


def build_edges(edge_list: list[dict], corr_capacity: int, num_edges_cap: int | None = None,
                device: str | torch.device = "cpu") -> PoseGraphEdges:
    """Pack a list of edges {"src", "dst", "p_src" (C_i, 3), "p_dst" (C_i, 3)}
    into padded tensors on `device`: correspondences truncated or padded to
    `corr_capacity`, edges padded (or cut) to `num_edges_cap`."""
    cap_e = num_edges_cap or max(len(edge_list), 1)
    src = np.zeros(cap_e, np.int64)
    dst = np.zeros(cap_e, np.int64)
    ps = np.zeros((cap_e, corr_capacity, 3), np.float32)
    pd = np.zeros((cap_e, corr_capacity, 3), np.float32)
    val = np.zeros((cap_e, corr_capacity), bool)
    edge_valid = np.zeros(cap_e, bool)
    for i, ed in enumerate(edge_list[:cap_e]):
        c = min(len(ed["p_src"]), corr_capacity)
        src[i], dst[i] = ed["src"], ed["dst"]
        ps[i, :c] = ed["p_src"][:c]
        pd[i, :c] = ed["p_dst"][:c]
        val[i, :c] = True
        edge_valid[i] = True
    return PoseGraphEdges(*(torch.from_numpy(a).to(device) for a in (src, dst, ps, pd, val, edge_valid)))
