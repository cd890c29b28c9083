"""Full bundle adjustment: keyframe poses and world points, Levenberg-Marquardt
over the Schur complement.

Port of `onepiece_tpu/optimization/bundle.py` (`BAObservations`, `BAProblem`,
`build_observations`, `ba_cost`, `ba_step`, `_ba_step_masked`,
`optimize_device`, `optimize`). The two observation models
(`_residuals_jacobians`, `_residuals_jacobians_3d`) and the RGB-D model's
sigma(z) and Huber constants are in `ops/ba_schur.py`, beside the kernel
that linearises them on the card. Poses are T_cw
(world -> camera); pose 0 (or every frame that `solve_frame` leaves out)
holds the gauge.

One damped step: `ops/ba_schur.reduced_system` forms the reduced camera
system S (6F, 6F) and rhs_c (on the card: the hand-written kernel of
`csrc/ba_schur.cu`), the masked system A = S (act x act) + diag(1 - act)
gets a scale-aware jitter and is solved, symmetrised, by LU
(`torch.linalg.solve_ex`: no error check that waits for the device; on the
card with cuSOLVER, chosen explicitly), and `ops/ba_schur.back_substitute`
gives the point steps. `optimize_device` is the whole LM loop on the device:
a host loop of `max_iters` steps, each accepted or rolled back with
`torch.where`, with no host read; `optimize` is the host-controlled loop
of the reference.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..ops import ba_schur
from ..utils import tracing

DEFAULT_MAX_ITERS = 20  # ref: BundleAdjustment.cpp LM outer iterations


class BAObservations(NamedTuple):
    frame: torch.Tensor  # (O,) int64
    point: torch.Tensor  # (O,) int64
    uv: torch.Tensor  # (O, 2) float32 observed pixels
    valid: torch.Tensor  # (O,) bool
    obs_of_point: torch.Tensor  # (P, Omax) int64 indices into O, -1 padded


class BAProblem(NamedTuple):
    poses: torch.Tensor  # (F, 4, 4) T_cw
    points: torch.Tensor  # (P, 3) world points
    obs: BAObservations


def build_observations(frame_idx: np.ndarray, point_idx: np.ndarray, uv: np.ndarray, num_points: int,
                       device: str | torch.device = "cpu") -> BAObservations:
    """Host helper: pack observation arrays and the per-point lists."""
    o = len(frame_idx)
    counts = np.bincount(point_idx, minlength=num_points)
    omax = max(int(counts.max()) if o else 1, 1)
    lists = np.full((num_points, omax), -1, np.int64)
    fill = np.zeros(num_points, np.int64)
    for i, p in enumerate(point_idx):
        lists[p, fill[p]] = i
        fill[p] += 1
    return BAObservations(
        torch.as_tensor(np.asarray(frame_idx, np.int64), device=device),
        torch.as_tensor(np.asarray(point_idx, np.int64), device=device),
        torch.as_tensor(np.asarray(uv, np.float32), device=device),
        torch.ones((o,), dtype=torch.bool, device=device),
        torch.as_tensor(lists, device=device),
    )


def ba_cost(problem: BAProblem, fx, fy, cx, cy):
    """(sum of w |r|^2, sum of w) of the 2-D model."""
    o = problem.obs
    r, _, _, w = ba_schur.residuals_jacobians_2d(problem.poses, problem.points, o.frame, o.point, o.uv, o.valid,
                                                 fx, fy, cx, cy)
    return torch.sum(w * torch.sum(r * r, -1)), torch.sum(w)


@contextlib.contextmanager
def _cusolver(dev: torch.device):
    """cuSOLVER for the LU of the step on the card: PyTorch's other backend
    (MAGMA) runs part of its factorisation on the host, which waits for the
    device."""
    if dev.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _ba_step_masked(poses, points, obs: BAObservations, solve_frame, lam, fx, fy, cx, cy, pc_obs=None,
                    lists: ba_schur.ObsLists | None = None):
    """One damped LM step over capacity-padded arrays: (new poses, new
    points, ok). `obs.valid` masks padding observations; `solve_frame` (F,)
    masks the pose blocks the reduced system solves (the others get an
    identity row and a zero step: the gauge and the capacity padding).
    Padding points have no observation: their damped V inverts to a large
    diagonal that multiplies zeros. `lam` is a 0-d float32 tensor. On the
    card the kernel walks `lists` (`ba_schur.build_lists`), made here when
    not given."""
    F = poses.shape[0]
    dev = poses.device
    if poses.is_cuda and lists is None:
        lists = ba_schur.build_lists(obs.frame, obs.point, obs.valid, F, points.shape[0])
    system = ba_schur.reduced_system(poses, points, obs.frame, obs.point, obs.uv, obs.valid, lam,
                                     (fx, fy, cx, cy), pc_obs, lists)
    act = solve_frame.to(poses.dtype)[:, None].expand(F, 6).reshape(F * 6)
    A = system.S * (act[:, None] * act[None, :]) + torch.diag(1.0 - act)
    diag = torch.diagonal(A)
    jitter = 1e-7 * torch.sum(diag * act) / torch.clamp(torch.sum(act), min=1.0) + 1e-9
    A = A + jitter * torch.eye(F * 6, dtype=A.dtype, device=dev)
    rhs = system.rhs_c * act
    with _cusolver(dev):
        dc, _ = torch.linalg.solve_ex(0.5 * (A + A.T), -rhs)
    ok = torch.all(torch.isfinite(dc))
    dc = torch.where(ok, dc * act, 0.0)
    dp = ba_schur.back_substitute(system, dc, obs.frame, obs.point, lists)
    dp = torch.where(ok, dp, 0.0)
    new_poses = se3.se3_exp(dc.reshape(F, 6)) @ poses
    return new_poses, points + dp, ok


def ba_step(problem: BAProblem, lam, fx, fy, cx, cy):
    """One damped step with pose 0 fixed: (new poses, new points, ok). The
    JAX package solves the (F - 1) x 6 sub-system; here it is the masked
    step with pose 0 as the only inactive frame (the same system, with an
    identity block for pose 0)."""
    poses = problem.poses
    lam = torch.as_tensor(lam, dtype=torch.float32, device=poses.device)
    solve = torch.arange(poses.shape[0], device=poses.device) > 0
    return _ba_step_masked(poses, problem.points, problem.obs, solve, lam, fx, fy, cx, cy)


def _center(T_cw: torch.Tensor) -> torch.Tensor:
    return -T_cw[:3, :3].T @ T_cw[:3, 3]


def optimize_device(
    poses, points, obs: BAObservations, solve_frame,
    fx, fy, cx, cy,
    max_iters: int = 10,
    lam0: float = 3e-5,
    anchor_scale: bool = True,
    pc_obs=None,
):
    """The whole LM loop (step, cost, accept or roll back, damping schedule)
    on the device, with no host read: lambda x0.7 on a cost decrease, x2
    and rollback on an increase (ref: BundleAdjustment.cpp:248-280), then,
    with `anchor_scale`, the 7th-gauge re-anchor that keeps the pose0 ->
    pose1 baseline length. With `pc_obs` (O, 3) the RGB-D model runs
    (scale is observable; `anchor_scale` should be False). The observation
    lists are sorted once, on the device. Returns (poses, points, mean
    squared error). Spans: `ba.lm`, its steps `ba.step` (the trial's cost
    and the decision `ba.accept`) and the final cost `ba.cost`."""
    with tracing.span("ba.lm", iters=max_iters):
        return _lm(poses, points, obs, solve_frame, fx, fy, cx, cy, max_iters, lam0, anchor_scale, pc_obs)


def _lm(poses, points, obs, solve_frame, fx, fy, cx, cy, max_iters, lam0, anchor_scale, pc_obs):
    F, P = poses.shape[0], points.shape[0]
    intr = (fx, fy, cx, cy)
    lists = ba_schur.build_lists(obs.frame, obs.point, obs.valid, F, P) if poses.is_cuda else None

    def cost_of(ps, pt):
        r, _, _, w = ba_schur._linearize(ps, pt, obs.frame, obs.point, obs.uv, obs.valid, intr, pc_obs)
        return torch.sum(w * r * r), torch.sum(w)

    c0 = _center(poses[0])
    baseline0 = torch.linalg.vector_norm(_center(poses[1]) - c0)
    cost, _ = cost_of(poses, points)
    lam = torch.full((), lam0, dtype=torch.float32, device=poses.device)
    for it in range(max_iters):
        with tracing.span("ba.step", it=it):
            np_, npt, ok = _ba_step_masked(poses, points, obs, solve_frame, lam, fx, fy, cx, cy, pc_obs, lists)
            with tracing.span("ba.accept"):
                new_cost, _ = cost_of(np_, npt)
                accept = ok & torch.isfinite(new_cost) & (new_cost < cost)
                poses = torch.where(accept, np_, poses)
                points = torch.where(accept, npt, points)
                lam = torch.where(accept, torch.clamp(lam * 0.7, min=1e-9), torch.clamp(lam * 2.0, max=1e6))
                cost = torch.where(accept, new_cost, cost)

    with tracing.span("ba.cost"):
        if anchor_scale:
            baseline1 = torch.linalg.vector_norm(_center(poses[1]) - c0)
            s = torch.where((baseline0 > 1e-9) & (baseline1 > 1e-9), baseline0 / baseline1, 1.0)
            R = poses[:, :3, :3]
            centers = -torch.einsum("fji,fj->fi", R, poses[:, :3, 3])
            new_t = -torch.einsum("fij,fj->fi", R, c0[None] + s * (centers - c0[None]))
            poses = torch.cat([torch.cat([R, new_t[..., None]], -1), poses[:, 3:]], 1)
            points = c0[None] + s * (points - c0[None])
            cost, _ = cost_of(poses, points)

        _, wsum = cost_of(poses, points)
        return poses, points, cost / torch.clamp(wsum, min=1.0)


def optimize(
    problem: BAProblem,
    fx: float, fy: float, cx: float, cy: float,
    max_iters: int = DEFAULT_MAX_ITERS,
    lam0: float = 3e-5,
    anchor_scale: bool = True,
    verbose: bool = False,
) -> tuple[BAProblem, float]:
    """LM loop with rollback, controlled from the host like the reference's
    outer loop (one host read of the cost per iteration). `anchor_scale`:
    pure-2D BA leaves a 7th gauge freedom (scaling every camera centre and
    point about the fixed pose 0), so after the loop the solution is
    re-scaled to keep the pose-0 -> pose-1 baseline. Returns (optimised
    problem, final mean squared reprojection error)."""
    F = problem.poses.shape[0]
    dev = problem.poses.device

    def center(T_cw):
        return -T_cw[:3, :3].T @ T_cw[:3, 3]

    init_poses = problem.poses.cpu().numpy()
    c0 = center(init_poses[0])
    baseline0 = float(np.linalg.norm(center(init_poses[1]) - c0)) if F >= 2 else 0.0

    lam = lam0
    cost = float(ba_cost(problem, fx, fy, cx, cy)[0])
    for it in range(max_iters):
        new_poses, new_points, _ = ba_step(problem, np.float32(lam), fx, fy, cx, cy)
        cand = BAProblem(new_poses, new_points, problem.obs)
        new_cost = float(ba_cost(cand, fx, fy, cx, cy)[0])
        if new_cost < cost:
            problem = cand
            cost = new_cost
            lam = max(lam * 0.7, 1e-9)  # ref: lambda x0.7 on success
        else:
            lam = min(lam * 2.0, 1e6)  # ref: x2 + rollback on failure
        if verbose:
            print(f"BA iter {it}: cost {cost:.6f} lam {lam:.2e}")

    if anchor_scale and F >= 2 and baseline0 > 1e-9:
        poses_o = problem.poses.cpu().numpy()
        baseline1 = float(np.linalg.norm(center(poses_o[1]) - c0))
        if baseline1 > 1e-9:
            s = baseline0 / baseline1
            new_poses = poses_o.copy()
            for i in range(F):
                R = poses_o[i, :3, :3]
                new_poses[i, :3, 3] = -R @ (c0 + s * (center(poses_o[i]) - c0))
            new_points = c0[None] + s * (problem.points.cpu().numpy() - c0[None])
            problem = BAProblem(torch.as_tensor(new_poses, device=dev),
                                torch.as_tensor(new_points, dtype=torch.float32, device=dev), problem.obs)
            cost = float(ba_cost(problem, fx, fy, cx, cy)[0])

    denom = float(ba_cost(problem, fx, fy, cx, cy)[1])
    return problem, cost / max(denom, 1.0)
