"""What the sparse kernels' calls must move and compute, from each call's
inputs: the counts of `chip_smoke.py` (`hamming_bytes_ops`,
`mild_bytes_ops`, `ba_bytes_ops` over the live frames and points), as
(bytes, operations) pairs. Hamming and MILD count `__popc` results, BA
float32 operations counted from `csrc/ba_schur.cu`."""

from __future__ import annotations

BA_OPS_PER_PAIR = 216  # one 6x6 block of 3-term dot products
BA_OPS_PER_OBS = 717  # residual and Jacobians, W/U/g/V/e and Y, U_f and rhs sums, W^T dc
BA_OPS_PER_POINT = 105  # damping, pivoted 3x3 inverse, dp
BA_OPS_PER_FRAME = 66  # U_f damping, added into S


def hamming_match(a, b, vb, uv_pred=None, uv_b=None, window: float = 0.0) -> tuple[int, int]:
    """Each query's descriptor (32 B) and, windowed, its uv (8 B) read once;
    every target's validity (1 B) and, of the valid ones, the descriptor
    and, windowed, the uv; 16 B a query written; 8 __popc for every (query,
    valid target in the window)."""
    n, m, n_valid = a.shape[0], b.shape[0], int(vb.sum())
    n_bytes = 32 * n + m + 32 * n_valid + 16 * n
    if uv_pred is None:
        pairs = n * n_valid
    else:
        n_bytes += 8 * (n + n_valid)
        inwin = ((uv_pred[:, None, 0] - uv_b[None, :, 0]).abs() <= window) & \
                ((uv_pred[:, None, 1] - uv_b[None, :, 1]).abs() <= window)
        pairs = int((inwin & vb[None]).sum())
    return n_bytes, 8 * pairs


def mild_feature_scores(q_desc, q_valid, db_desc, db_valid, g) -> tuple[int, int]:
    """Every query's validity and the live keyframes' features' validity
    (1 B), the valid ones' descriptors (32 B), g and the table once; the
    score table written (4 B an entry); 8 __popc for every (valid query,
    valid feature of a keyframe before g)."""
    n, (n_cap, f) = q_desc.shape[0], db_desc.shape[:2]
    live = min(n_cap, int(g))
    n_q, n_f = int(q_valid.sum()), int(db_valid[:live].sum())
    return n + 32 * n_q + live * f + 32 * n_f + 4 * n * n_cap + 8 + 256, 8 * n_q * n_f


def ba_step(num_frames: int, num_points: int, lists, rgbd: bool) -> tuple[int, int]:
    """One LM step's Schur work over the frames and points that hold an
    observation: each valid observation's indices (16 B), measurement (12 B
    camera point or 8 B pixel) and list entries (16 B) read once; each
    pose, list offset and camera step; each point and its offset; S (36 F^2
    floats), rhs, V^-1, b_p and dp written once. Operations from the
    kernels' code."""
    n_f = int((lists.frame_ptr.diff() > 0).sum())
    n_p = int((lists.point_ptr.diff() > 0).sum())
    n_obs = int(lists.frame_ptr[-1])
    n_pairs = int((lists.point_ptr.diff() ** 2).sum())
    meas = 12 if rgbd else 8
    n_bytes = (n_obs * (16 + meas + 16) + n_f * (64 + 8 + 24) + n_p * (12 + 8) + 4
               + 36 * n_f * n_f * 4 + 24 * n_f + 60 * n_p)
    n_ops = BA_OPS_PER_PAIR * n_pairs + BA_OPS_PER_OBS * n_obs + BA_OPS_PER_POINT * n_p + BA_OPS_PER_FRAME * n_f
    return n_bytes, n_ops
