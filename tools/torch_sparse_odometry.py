#!/usr/bin/env python3
"""Sparse (FAST/BRIEF) odometry over a sequence, on the port.

    python3 tools/torch_sparse_odometry.py --dataset DIR                  # a TUM folder, on the card
    python3 tools/torch_sparse_odometry.py --synthetic 8 --scale 4 --device cpu

The counterpart of `tools/sparse_odometry.py` for `onepiece_tpu_torch`:
tracks each frame against the previous with the feature front end
(`odometry/sparse.extract_sparse_frame`) and `sparse_tracking` (descriptor
matching on the Hamming kernel of `csrc/hamming.cu` on the card,
RanSaPC, batched RANSAC, the windowed re-match), keeps the previous pose
where tracking fails, writes the trajectory and reports the ATE where there
is ground truth. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from _torch_common import add_dataset_args, load_frames, print_ate

from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.odometry import sparse


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_dataset_args(ap)
    ap.add_argument("--out", type=str, default="trajectory_sparse.txt")
    ap.add_argument("--fast-threshold", type=float, default=0.01)  # 0.05 starves low-contrast scenes
    args = ap.parse_args()

    frames, cam, gt = load_frames(args)

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32).to(args.device)

    poses = [np.eye(4, dtype=np.float32)]
    prev = None
    t0 = time.perf_counter()
    n = fails = 0
    for _, gray, depth in frames:
        f = sparse.extract_sparse_frame(tensor(gray), tensor(depth), cam, threshold=args.fast_threshold)
        if prev is not None:
            res = sparse.sparse_tracking(prev, f, cam)
            ok = bool(res.success)
            if ok:
                poses.append(poses[-1] @ np.linalg.inv(res.T_ts.cpu().numpy()))
            else:
                poses.append(poses[-1].copy())
                fails += 1
            print(f"frame {n}: inliers {int(res.num_inliers)} rmse {float(res.rmse):.4f} ok={ok}")
        prev = f
        n += 1
    dt = time.perf_counter() - t0
    print(f"tracked {n} frames in {dt:.2f}s ({n / dt:.2f} fps), {fails} failures")
    traj.write_matrix_trajectory(args.out, np.stack(poses))
    print_ate(np.stack(poses), gt)


if __name__ == "__main__":
    main()
