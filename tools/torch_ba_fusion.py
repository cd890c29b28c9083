#!/usr/bin/env python3
"""BAFusion on the PyTorch + CUDA port: sparse keyframe SLAM with world-point
tracks and full bundle adjustment on the device, then a mesh.

    python3 tools/torch_ba_fusion.py --synthetic 16                      # 640x480 orbit, on the card
    python3 tools/torch_ba_fusion.py --synthetic 100 --trajectory loop --chunk 25 --out-mesh ba.ply
    python3 tools/torch_ba_fusion.py --synthetic 8 --scale 4 --device cpu --chunk 4

Renders N frames of the synthetic orbit or closed loop (the TUM reader is
not ported yet) and runs `FusedBASlam` chunk by chunk: the FBAFusion front
end (features, sparse tracking, MILD loop closure, the pose-graph warm
start), then on the device the track linker and the LM loop over keyframe
poses and world points, whose Schur reduction is the hand-written kernel of
`csrc/ba_schur.cu` on the card. Prints the ATE against the renderer's poses
and writes the trajectory. With `--out-mesh`, every `--integrate-stride`-th
frame is fused at its optimised pose, as `tools/torch_fba_fusion.py` does:
`bilateral_filter` -> `TSDFVolume.integrate` -> `extract_mesh_tensors` ->
the dedup on the device -> PLY. Imports nothing of the JAX package. The JAX
package's `tools/ba_fusion.py` drives its host-loop `BASlam`
(`systems/baslam.py`), which is not ported; this tool drives the
device-resident system that `bench.py` measures.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from torch_fba_fusion import fuse
from torch_fused_fusion import add_synthetic_args, synthetic_frames, write_mesh

from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.systems.fused_ba import FusedBASlam
from onepiece_tpu_torch.systems.fused_sparse import KEYFRAME_DISPARITY
from onepiece_tpu_torch.utils import synthetic


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_synthetic_args(ap)
    ap.add_argument("--out-mesh", type=str, default="")
    ap.add_argument("--out-traj", type=str, default="trajectory_ba.txt")
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--integrate-stride", type=int, default=8)
    ap.add_argument("--keyframe-disparity", type=float, default=KEYFRAME_DISPARITY)
    ap.add_argument("--chunk", type=int, default=16, help="frames per process_chunk call")
    ap.add_argument("--ba-every", type=int, default=1, help="run the BA solve every N-th chunk")
    ap.add_argument("--trajectory", choices=("orbit", "loop"), default="orbit",
                    help="synthetic orbit_trajectory or the closed loop_trajectory")
    args = ap.parse_args()

    cam, gt, grays, depths = synthetic_frames(
        args, synthetic.orbit_trajectory if args.trajectory == "orbit" else synthetic.loop_trajectory)
    slam = FusedBASlam(cam, keyframe_disparity=args.keyframe_disparity, ba_every_chunks=args.ba_every,
                       device=args.device)
    t0 = time.perf_counter()
    for i in range(0, len(grays), args.chunk):
        print(f"chunk -> {slam.process_chunk(grays[i : i + args.chunk], depths[i : i + args.chunk])}")
    dt = time.perf_counter() - t0
    n = slam.frame_count
    print(f"slam: {n} frames, {slam.num_kf} keyframes, {slam.num_edges} edges ({slam.lc_edges_total} LC), "
          f"{slam.n_pts} world points, {slam.n_obs} observations, BA mse {slam.ba_mse:.3g}, overflow "
          f"edges {slam.edge_overflow} points {slam.pt_overflow} observations {slam.obs_overflow} in {dt:.2f}s "
          f"({n / dt:.2f} fps)")
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
