#!/usr/bin/env python3
"""FBAFusion on the PyTorch + CUDA port: sparse keyframe SLAM, then a mesh.

    python3 tools/torch_fba_fusion.py --dataset DIR                       # a TUM folder, on the card
    python3 tools/torch_fba_fusion.py --synthetic 16                      # 640x480 orbit, on the card
    python3 tools/torch_fba_fusion.py --synthetic 100 --trajectory loop --chunk 25 --out-mesh fba.ply
    python3 tools/torch_fba_fusion.py --synthetic 8 --scale 4 --device cpu
    python3 tools/torch_fba_fusion.py --dataset DIR --max-frames 16 --checkpoint c.npz
    python3 tools/torch_fba_fusion.py --dataset DIR --resume c.npz       # frames 16.. continue the run
    python3 tools/torch_fba_fusion.py --synthetic 16 --per-frame          # the host-loop FBASlam

The counterpart of `tools/fba_fusion.py`'s fused path for
`onepiece_tpu_torch`: reads a TUM folder or renders N frames of the
synthetic orbit or closed loop, runs `FusedFBASlam` chunk by chunk
(FAST/BRIEF features, sparse tracking with the failure ladder, MILD loop
closure and the pose graph, the Hamming kernel under matching and loop
closure), prints the ATE against the ground truth and writes the
trajectory. With `--out-mesh`, every `--integrate-stride`-th frame is fused
at its optimised pose: `bilateral_filter` -> `TSDFVolume.integrate` (the
TSDF kernel) -> `extract_mesh_tensors` (the marching-cubes kernel) -> the
dedup on the device -> PLY. `--checkpoint` / `--resume` save and restore
the whole SLAM state (`utils/checkpoint.py`, the JAX package's format); a
resumed run skips the frames the checkpoint holds. `--per-frame` runs the
host-loop `systems/fbaslam.FBASlam` frame by frame instead (the reference's
control flow: loop closure and the pose graph at every keyframe, the
relocalisation of lost frames), as the JAX CLI's `--per-frame` does; it
takes no checkpoint flag. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_common import add_sparse_args, load_frames, run

from onepiece_tpu_torch.systems.fbaslam import FBASlam
from onepiece_tpu_torch.systems.fused_sparse import FusedFBASlam
from onepiece_tpu_torch.utils import checkpoint as ckpt


def describe(slam: FusedFBASlam) -> str:
    return (f"slam: {slam.frame_count} frames, {slam.num_kf} keyframes, {slam.num_edges} edges "
            f"({slam.lc_edges_total} LC), overflow {slam.edge_overflow}")


def describe_host_loop(slam: FBASlam) -> str:
    return (f"slam: {slam.frame_count} frames, {len(slam.keyframe_frames)} keyframes, {len(slam.edges)} edges "
            f"({slam.lc_edges} LC)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_sparse_args(ap, "trajectory_sparse.txt")
    ap.add_argument("--fast-threshold", type=float, default=0.01)
    ap.add_argument("--checkpoint", type=str, default=None, help="write a full-SLAM-state checkpoint here at the end")
    ap.add_argument("--resume", type=str, default=None, help="resume from a checkpoint written by --checkpoint")
    ap.add_argument("--per-frame", action="store_true", help="the host-loop FBASlam instead of the fused chunked path")
    args = ap.parse_args()

    frames, cam, gt = load_frames(args)
    if args.per_frame:
        if args.checkpoint or args.resume:
            raise SystemExit("--per-frame takes no --checkpoint / --resume")
        slam = FBASlam(cam, fast_threshold=args.fast_threshold, keyframe_disparity=args.keyframe_disparity,
                       device=args.device)
        run(slam, frames, args, gt, cam, describe_host_loop, per_frame=True)
        return
    if args.resume:
        slam = ckpt.load(args.resume, cam, device=args.device)
        frames = itertools.islice(frames, slam.frame_count, None)
        print(f"resumed from {args.resume} at frame {slam.frame_count}")
    else:
        slam = FusedFBASlam(cam, fast_threshold=args.fast_threshold, keyframe_disparity=args.keyframe_disparity,
                            device=args.device)
    run(slam, frames, args, gt, cam, describe)
    if args.checkpoint:
        ckpt.save(slam, args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}")


if __name__ == "__main__":
    main()
