"""Trajectory IO and evaluation (numpy). Copy of the jax-free trajectory
IO (16-float matrix rows and TUM's `t tx ty tz qx qy qz qw` lines) and
evaluation helpers of `onepiece_tpu/io/trajectory.py`."""

from __future__ import annotations

import numpy as np


def write_matrix_trajectory(path: str, poses: np.ndarray) -> None:
    """Write (N, 4, 4) poses as 16-float rows."""
    flat = np.asarray(poses).reshape(len(poses), 16)
    np.savetxt(path, flat, fmt="%.9f")


def read_matrix_trajectory(path: str) -> np.ndarray:
    flat = np.loadtxt(path)
    if flat.ndim == 1:
        flat = flat[None]
    return flat.reshape(-1, 4, 4)


def write_tum_trajectory(path: str, timestamps: np.ndarray, poses: np.ndarray) -> None:
    """TUM format: `t tx ty tz qx qy qz qw` per line."""
    from scipy.spatial.transform import Rotation

    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses):
            q = Rotation.from_matrix(T[:3, :3]).as_quat()  # x y z w
            t = T[:3, 3]
            f.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def read_tum_trajectory(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps (N,), poses (N, 4, 4))."""
    from scipy.spatial.transform import Rotation

    rows = np.loadtxt(path, comments="#")
    if rows.ndim == 1:
        rows = rows[None]
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :3] = Rotation.from_quat(rows[:, 4:8]).as_matrix()
    poses[:, :3, 3] = rows[:, 1:4]
    return rows[:, 0], poses


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
