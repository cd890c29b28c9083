#!/usr/bin/env python3
"""Frame-to-frame dense RGB-D odometry over a sequence, on the port.

    python3 tools/torch_dense_odometry.py --dataset DIR                   # a TUM folder, on the card
    python3 tools/torch_dense_odometry.py --synthetic 16 --scale 4 --device cpu

The counterpart of `tools/dense_odometry.py` for `onepiece_tpu_torch`:
tracks each frame against the previous (`odometry/dense.dense_tracking`,
the Gauss-Newton step kernel of `csrc/dense_normal_eq.cu` on the card),
initialised with the previous relative pose, chains the global poses,
writes the trajectory (16-float rows) and reports the ATE where there is
ground truth. Prints each frame's rmse and inliers (one host read a frame).
Imports nothing of the JAX package.
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
from onepiece_tpu_torch.odometry import dense


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_dataset_args(ap)
    ap.add_argument("--out", type=str, default="trajectory.txt")
    args = ap.parse_args()

    frames, cam, gt = load_frames(args)

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32).to(args.device)

    poses = [np.eye(4, dtype=np.float32)]
    prev_pyr, prev_rel = None, torch.eye(4, device=args.device)
    t0 = time.perf_counter()
    n = 0
    for _, gray, depth in frames:
        pyr = dense.preprocess_frame(tensor(gray), tensor(depth), cam)
        if prev_pyr is not None:
            res = dense.dense_tracking(prev_pyr, pyr, cam, init_T=prev_rel)
            T_ts = res.T_ts.cpu().numpy()
            poses.append(poses[-1] @ np.linalg.inv(T_ts))
            prev_rel = res.T_ts
            print(f"frame {n}: rmse {float(res.rmse):.5f} inliers {int(res.num_inliers)}")
        prev_pyr = pyr
        n += 1
    dt = time.perf_counter() - t0
    print(f"tracked {n} frames in {dt:.2f}s ({n / dt:.2f} fps)")
    traj.write_matrix_trajectory(args.out, np.stack(poses))
    print(f"wrote {args.out}")
    print_ate(np.stack(poses), gt)


if __name__ == "__main__":
    main()
