#!/usr/bin/env python3
"""TSDF integration at known poses, then a marching-cubes mesh, on the port.

    python3 tools/torch_image_sequence_integration.py --dataset DIR          # ground-truth poses, on the card
    python3 tools/torch_image_sequence_integration.py --dataset DIR --trajectory poses.txt --stride 2
    python3 tools/torch_image_sequence_integration.py --synthetic 8 --scale 4 --device cpu

The counterpart of `tools/image_sequence_integration.py` for
`onepiece_tpu_torch`: isolates the reconstruction stack from odometry.
Every `--stride`-th frame is integrated into a `TSDFVolume(voxel,
truncation = 5 voxel)` at its pose from `--trajectory` (16-float rows) or
the dataset's ground truth (the TSDF kernel of `csrc/tsdf_integrate.cu` on
the card), then meshed (the marching-cubes kernel), the vertices merged on
the device and written as PLY. With ground truth it also prints the ATE of
the poses against it (0 where the poses are the ground truth). Imports
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from _torch_common import add_dataset_args, load_frames, print_ate, write_mesh

from onepiece_tpu_torch.integration.blocks import TSDFVolume
from onepiece_tpu_torch.io import trajectory as traj


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_dataset_args(ap)
    ap.add_argument("--trajectory", dest="poses_file", type=str, default="",
                    help="16-float-row trajectory; defaults to dataset GT")
    ap.add_argument("--out-mesh", type=str, default="mesh.ply")
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--stride", type=int, default=1)
    args = ap.parse_args()

    frames, cam, gt = load_frames(args)
    poses = traj.read_matrix_trajectory(args.poses_file) if args.poses_file else gt
    if poses is None:
        raise SystemExit("no trajectory available (pass --trajectory or use GT)")

    vol = TSDFVolume(voxel_size=args.voxel, truncation=args.voxel * 5, device=args.device)
    t0 = time.perf_counter()
    count = 0
    for i, (_, gray, depth) in enumerate(frames):
        if i >= len(poses):
            break
        if i % args.stride:
            continue
        gray = torch.as_tensor(gray, dtype=torch.float32).to(args.device)
        depth = torch.as_tensor(depth, dtype=torch.float32).to(args.device)
        vol.integrate(depth, gray[..., None].expand(-1, -1, 3), np.asarray(poses[i], np.float32), cam)
        count += 1
    dt = time.perf_counter() - t0
    print(f"integrated {count} frames in {dt:.2f}s ({count / dt:.2f} fps); blocks {vol.num_active}")
    print_ate(np.asarray(poses), gt)
    nv, nf, secs = write_mesh(vol, args.out_mesh)
    print(f"mesh: {nv} verts {nf} faces in {secs:.2f}s -> {args.out_mesh}")


if __name__ == "__main__":
    main()
