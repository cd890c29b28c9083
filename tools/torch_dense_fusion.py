#!/usr/bin/env python3
"""DenseFusion on the PyTorch + CUDA port: DenseSlam, then a post-hoc TSDF mesh.

    python3 tools/torch_dense_fusion.py --dataset DIR                       # a TUM folder, on the card
    python3 tools/torch_dense_fusion.py --synthetic 150                     # 640x480, on the card
    python3 tools/torch_dense_fusion.py --synthetic 4 --scale 8 --device cpu
    python3 tools/torch_dense_fusion.py --synthetic 150 --turntable tt    # + 24 views of the mesh, tt/turntable.gif

The counterpart of `tools/dense_fusion.py` for `onepiece_tpu_torch`: reads
a TUM folder or renders N frames of the synthetic orbit, runs `DenseSlam`
(dense VO, submap ICP, loop closure, pose graph) over them, then runs
DenseFusion's post-hoc reconstruction (`dense_slam.reconstruct`): every
`--integrate-stride`-th frame, bilateral-filtered, into a
`TSDFVolume(voxel, truncation = 5 voxel)` at the optimised poses (the TSDF
kernel), meshed (the marching-cubes kernel), and writes the trajectory and
the PLY. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_common import add_dataset_args, add_turntable_arg, fuse, keeping, load_frames, print_ate, write_mesh

from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.systems.dense_slam import DenseSlam


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_dataset_args(ap)
    ap.add_argument("--out-mesh", type=str, default="mesh.ply")
    ap.add_argument("--out-traj", type=str, default="trajectory.txt")
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--integrate-stride", type=int, default=8, help="integrate every k-th frame")
    ap.add_argument("--submap-size", type=int, default=50)
    add_turntable_arg(ap)
    args = ap.parse_args()

    frames, cam, gt = load_frames(args)
    slam = DenseSlam(cam, args.device, submap_size=args.submap_size)
    kept: list = []
    t0 = time.perf_counter()
    for _, gray, depth in keeping(frames, 0, args.integrate_stride, kept):
        info = slam.update_frame(gray, depth)
        if info["frame"] % 10 == 0:
            print(f"frame {info['frame']}: rmse {info['rmse']:.5f} submap {info['submap']}")
    n = slam.frame_count
    dt = time.perf_counter() - t0
    print(f"slam: {n} frames in {dt:.2f}s ({n / dt:.2f} fps)")
    poses = slam.trajectory()
    traj.write_matrix_trajectory(args.out_traj, poses)
    print_ate(poses, gt)

    # post-hoc reconstruction at the optimised poses (dense_slam.reconstruct)
    t1 = time.perf_counter()
    vol, mesh = fuse(poses, kept, cam, args.voxel, args.device)
    print(f"integrated {len(kept)} frames and meshed in {time.perf_counter() - t1:.2f}s; blocks {vol.num_active}")
    nv, nf, secs = write_mesh(vol, args.out_mesh, args.turntable, mesh=mesh)
    print(f"mesh: {nv} verts {nf} faces in {secs:.2f}s -> {args.out_mesh}")


if __name__ == "__main__":
    main()
