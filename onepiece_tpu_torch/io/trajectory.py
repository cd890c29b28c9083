"""Trajectory evaluation (numpy). Copy of the jax-free evaluation helpers of
`onepiece_tpu/io/trajectory.py`."""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False) -> np.ndarray:
    """Best rigid (or similarity) transform aligning est positions (N, 3) to
    gt (N, 3): the Horn/Umeyama closed form used by TUM's evaluate_ate."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    ec = est - mu_e
    gc = gt - mu_g
    H = gc.T @ ec / len(est)
    U, S, Vt = np.linalg.svd(H)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((ec**2).sum() / len(est)) if with_scale else 1.0
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = mu_g - s * R @ mu_e
    return T


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE between (N, 4, 4) pose arrays."""
    est = np.asarray(est_poses)[:, :3, 3]
    gt = np.asarray(gt_poses)[:, :3, 3]
    if align:
        T = align_umeyama(est, gt)
        est = est @ T[:3, :3].T + T[:3, 3]
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=-1).mean()))


def rpe_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> tuple[float, float]:
    """Relative pose error RMSE (translational meters, rotational radians)."""
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    terrs, rerrs = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        rerrs.append(np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(np.sqrt(np.mean(np.square(rerrs))))
