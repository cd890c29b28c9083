#!/usr/bin/env python3
"""FusedFusion on the PyTorch + CUDA port: dense SLAM + TSDF fusion, then a mesh.

    python3 tools/torch_fused_fusion.py --dataset DIR                       # a TUM folder, on the card
    python3 tools/torch_fused_fusion.py --synthetic 16                      # 640x480, on the card
    python3 tools/torch_fused_fusion.py --synthetic 4 --scale 8 --device cpu
    python3 tools/torch_fused_fusion.py --dataset DIR --max-frames 8 --checkpoint c.npz
    python3 tools/torch_fused_fusion.py --dataset DIR --resume c.npz      # frames 8.. continue the run
    python3 tools/torch_fused_fusion.py --synthetic 16 --turntable tt     # + 24 views of the mesh, tt/turntable.gif

The counterpart of `tools/fused_fusion.py` for `onepiece_tpu_torch`: reads
a TUM folder (`io/tum.py`, decoded as the loop consumes it) or renders N
frames of the synthetic orbit, runs `FusedDenseFusion` (tracking and fusion
on the device, no host sync per frame), then `finalize` ->
`to_volume().extract_mesh_tensors()` (the marching-cubes kernel) ->
`ops/mesh_dedup.dedup_triangle_soup` on the device -> one copy to the host
-> `write_ply_mesh`. Prints fps, blocks, overflow, ATE against the ground
truth and the mesh's size and time. `--checkpoint` writes the whole SLAM
state at the end (`utils/checkpoint.py`, the JAX package's format);
`--resume` continues from one, skipping the frames it already holds.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_common import add_dataset_args, add_turntable_arg, chunks, load_frames, print_ate, write_mesh

from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
from onepiece_tpu_torch.utils import checkpoint as ckpt


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_dataset_args(ap)
    ap.add_argument("--out-mesh", type=str, default="fused_mesh.ply")
    ap.add_argument("--out-traj", type=str, default="fused_trajectory.txt")
    ap.add_argument("--voxel", type=float, default=0.0125)
    ap.add_argument("--capacity", type=int, default=16384)
    ap.add_argument("--chunk", type=int, default=1, help="frames per process_chunk call")
    ap.add_argument("--checkpoint", type=str, default=None, help="write a full-SLAM-state checkpoint here at the end")
    ap.add_argument("--resume", type=str, default=None, help="resume from a checkpoint written by --checkpoint")
    add_turntable_arg(ap)
    args = ap.parse_args()

    frames, cam, gt = load_frames(args)
    if args.resume:
        slam = ckpt.load(args.resume, cam, device=args.device)
        frames = itertools.islice(frames, slam.frame_count, None)
        print(f"resumed from {args.resume} at frame {slam.frame_count}")
    else:
        slam = FusedDenseFusion(cam, device=args.device, voxel_size=args.voxel, truncation=args.voxel * 8,
                                capacity=args.capacity)
    n0 = slam.frame_count
    t0 = time.perf_counter()
    for grays, depths in chunks(frames, args.chunk, args.device):
        slam.process_chunk(grays, depths)
    poses, _ = slam.finalize()
    dt = time.perf_counter() - t0
    n = slam.frame_count - n0
    print(f"fused slam: {n} frames in {dt:.2f}s ({n / dt:.2f} fps), "
          f"{slam.num_active} blocks, overflow {slam.overflow}")
    traj.write_matrix_trajectory(args.out_traj, poses)
    if args.checkpoint:
        ckpt.save(slam, args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}")
    print_ate(poses, gt)
    nv, nf, secs = write_mesh(slam.to_volume(), args.out_mesh, args.turntable)
    print(f"mesh: {nv} verts {nf} faces in {secs:.2f}s -> {args.out_mesh}")


if __name__ == "__main__":
    main()
