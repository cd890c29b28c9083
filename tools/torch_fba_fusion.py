#!/usr/bin/env python3
"""FBAFusion on the PyTorch + CUDA port: sparse keyframe SLAM, then a mesh.

    python3 tools/torch_fba_fusion.py --synthetic 16                      # 640x480 orbit, on the card
    python3 tools/torch_fba_fusion.py --synthetic 100 --trajectory loop --chunk 25 --out-mesh fba.ply
    python3 tools/torch_fba_fusion.py --synthetic 8 --scale 4 --device cpu

The counterpart of `tools/fba_fusion.py`'s fused path for
`onepiece_tpu_torch`: renders N frames of the synthetic orbit or closed
loop (the TUM reader is not ported yet), runs `FusedFBASlam` chunk by chunk (FAST/BRIEF
features, sparse tracking with the failure ladder, MILD loop closure and the
pose graph, the Hamming kernel under matching and loop closure), prints the
ATE against the renderer's poses and writes the trajectory. With
`--out-mesh`, every `--integrate-stride`-th frame is fused at its optimised
pose: `bilateral_filter` -> `TSDFVolume.integrate` (the TSDF kernel) ->
`extract_mesh_tensors` (the marching-cubes kernel) -> the dedup on the
device -> PLY. Imports nothing of the JAX package. (`--per-frame`,
`--checkpoint` and `--resume` of the JAX CLI need modules not ported yet.)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from torch_fused_fusion import add_synthetic_args, synthetic_frames, write_mesh

from onepiece_tpu_torch.integration.blocks import TSDFVolume
from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.ops.image import bilateral_filter
from onepiece_tpu_torch.systems.fused_sparse import KEYFRAME_DISPARITY, FusedFBASlam
from onepiece_tpu_torch.utils import synthetic


def fuse(poses: np.ndarray, grays, depths, cam, voxel: float, stride: int, device) -> TSDFVolume:
    """Every `stride`-th frame fused at its pose, colour = gray."""
    vol = TSDFVolume(voxel_size=voxel, truncation=voxel * 5, device=device)
    for f in range(0, len(poses), stride):
        vol.integrate(bilateral_filter(depths[f]), grays[f][..., None].expand(-1, -1, 3), poses[f], cam)
    return vol


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_synthetic_args(ap)
    ap.add_argument("--out-mesh", type=str, default="")
    ap.add_argument("--out-traj", type=str, default="trajectory_sparse.txt")
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--integrate-stride", type=int, default=8)
    ap.add_argument("--fast-threshold", type=float, default=0.01)
    ap.add_argument("--keyframe-disparity", type=float, default=KEYFRAME_DISPARITY)
    ap.add_argument("--chunk", type=int, default=16, help="frames per process_chunk call")
    ap.add_argument("--trajectory", choices=("orbit", "loop"), default="orbit",
                    help="synthetic orbit_trajectory or the closed loop_trajectory")
    args = ap.parse_args()

    cam, gt, grays, depths = synthetic_frames(
        args, synthetic.orbit_trajectory if args.trajectory == "orbit" else synthetic.loop_trajectory)
    slam = FusedFBASlam(cam, fast_threshold=args.fast_threshold, keyframe_disparity=args.keyframe_disparity,
                        device=args.device)
    t0 = time.perf_counter()
    for i in range(0, len(grays), args.chunk):
        print(f"chunk -> {slam.process_chunk(grays[i : i + args.chunk], depths[i : i + args.chunk])}")
    dt = time.perf_counter() - t0
    n = slam.frame_count
    print(f"slam: {n} frames, {slam.num_kf} keyframes, {slam.num_edges} edges ({slam.lc_edges_total} LC), "
          f"overflow {slam.edge_overflow} in {dt:.2f}s ({n / dt:.2f} fps)")
    poses = slam.trajectory()
    traj.write_matrix_trajectory(args.out_traj, poses)
    print(f"ATE RMSE ({n} frames): {traj.ate_rmse(poses, np.asarray(gt)[:n]):.5f} m")
    if args.out_mesh:
        vol = fuse(poses, grays, depths, cam, args.voxel, args.integrate_stride, args.device)
        nv, nf, secs = write_mesh(vol, args.out_mesh)
        print(f"mesh: {vol.num_active} blocks, {nv} verts {nf} faces in {secs:.2f}s -> {args.out_mesh} "
              f"(key-saturated frames {vol.key_saturated_frames})")


if __name__ == "__main__":
    main()
