#!/usr/bin/env python3
"""BAFusion on the PyTorch + CUDA port: sparse keyframe SLAM with world-point
tracks and full bundle adjustment on the device, then a mesh.

    python3 tools/torch_ba_fusion.py --dataset DIR                       # a TUM folder, on the card
    python3 tools/torch_ba_fusion.py --synthetic 16                      # 640x480 orbit, on the card
    python3 tools/torch_ba_fusion.py --synthetic 100 --trajectory loop --chunk 25 --out-mesh ba.ply
    python3 tools/torch_ba_fusion.py --synthetic 8 --scale 4 --device cpu --chunk 4
    python3 tools/torch_ba_fusion.py --synthetic 16 --host-loop --chunk 0      # BASlam, frame by frame
    python3 tools/torch_ba_fusion.py --synthetic 100 --trajectory loop --host-loop --chunk 25

Reads a TUM folder or renders N frames of the synthetic orbit or closed
loop and runs `FusedBASlam` chunk by chunk: the FBAFusion front end
(features, sparse tracking, MILD loop closure, the pose-graph warm start),
then on the device the track linker and the LM loop over keyframe poses and
world points, whose Schur reduction is the hand-written kernel of
`csrc/ba_schur.cu` on the card. Prints the ATE against the ground truth and
writes the trajectory. With `--out-mesh`, every `--integrate-stride`-th
frame is fused at its optimised pose, as `tools/torch_fba_fusion.py` does:
`bilateral_filter` -> `TSDFVolume.integrate` -> `extract_mesh_tensors` ->
the dedup on the device -> PLY. Imports nothing of the JAX package.

`--host-loop` drives the host-loop `systems/baslam.BASlam` instead, as the
JAX package's `tools/ba_fusion.py` does: with `--chunk 0` its per-frame loop
(BA at every `--ba-every`-th keyframe), else its `process_chunk` in chunks
of `--chunk`; the final BA's reprojection rmse is printed. By default the
tool drives the device-resident FusedBASlam (`--ba-every`: every N-th
chunk). Like the JAX tool, it takes no checkpoint flag
(`utils/checkpoint.py` saves a FusedBASlam all the same).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_common import add_sparse_args, load_frames, run

from onepiece_tpu_torch.systems.baslam import BASlam
from onepiece_tpu_torch.systems.fused_ba import FusedBASlam


def describe(slam: FusedBASlam) -> str:
    return (f"slam: {slam.frame_count} frames, {slam.num_kf} keyframes, {slam.num_edges} edges "
            f"({slam.lc_edges_total} LC), {slam.n_pts} world points, {slam.n_obs} observations, BA mse "
            f"{slam.ba_mse:.3g}, overflow edges {slam.edge_overflow} points {slam.pt_overflow} observations "
            f"{slam.obs_overflow}")


def describe_host_loop(slam: BASlam) -> str:
    return (f"slam: {slam.frame_count} frames, {len(slam.keyframe_frames)} keyframes, {len(slam.world_points)} "
            f"world points, {len(slam.observations)} observations, {slam.lc_edges} LC pairs linked")


def final_ba(slam: BASlam) -> None:
    """One more BA over everything, before the trajectory is written (as the
    JAX tool runs it)."""
    mse = slam.optimize()
    if mse is not None:
        print(f"final BA reprojection rmse: {mse ** 0.5:.4f} px (mean squared error {mse:.4f} px^2)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_sparse_args(ap, "trajectory_ba.txt")
    ap.add_argument("--ba-every", type=int, default=1,
                    help="run the BA solve every N-th chunk (every N-th keyframe with --host-loop)")
    ap.add_argument("--host-loop", action="store_true",
                    help="the host-loop BASlam: per frame with --chunk 0, else process_chunk in chunks of --chunk")
    ap.add_argument("--fast-threshold", type=float, default=0.01, help="FAST threshold (--host-loop)")
    args = ap.parse_args()

    frames, cam, gt = load_frames(args)
    if args.host_loop:
        slam = BASlam(cam, fast_threshold=args.fast_threshold, keyframe_disparity=args.keyframe_disparity,
                      ba_every=args.ba_every, device=args.device)
        run(slam, frames, args, gt, cam, describe_host_loop, per_frame=args.chunk <= 0, finish=final_ba)
        return
    slam = FusedBASlam(cam, keyframe_disparity=args.keyframe_disparity, ba_every_chunks=args.ba_every,
                       device=args.device)
    run(slam, frames, args, gt, cam, describe)


if __name__ == "__main__":
    main()
