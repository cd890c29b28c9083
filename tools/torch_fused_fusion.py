#!/usr/bin/env python3
"""FusedFusion on the PyTorch + CUDA port: dense SLAM + TSDF fusion, then a mesh.

    python3 tools/torch_fused_fusion.py --synthetic 16                      # 640x480, on the card
    python3 tools/torch_fused_fusion.py --synthetic 4 --scale 8 --device cpu

The counterpart of `tools/fused_fusion.py` for `onepiece_tpu_torch`: renders
N frames of the synthetic orbit (the TUM reader is not ported yet), runs
`FusedDenseFusion` (tracking and fusion on the device, no host sync per
frame), then `finalize` -> `to_volume().extract_mesh_tensors()` (the
marching-cubes kernel) -> `ops/mesh_dedup.dedup_triangle_soup` on the device
-> one copy to the host -> `write_ply_mesh`. Prints fps, blocks,
overflow, ATE against the renderer's poses and the mesh's size and time.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from onepiece_tpu_torch.geometry.camera import PRESETS
from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.io.ply import write_ply_mesh
from onepiece_tpu_torch.ops.mesh_dedup import dedup_triangle_soup
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
from onepiece_tpu_torch.utils import synthetic


def add_synthetic_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--synthetic", type=int, required=True, help="render N synthetic orbit frames")
    ap.add_argument("--camera", type=str, default="tum", choices=list(PRESETS))
    ap.add_argument("--scale", type=int, default=1, help="downscale factor of camera and render (power of 2)")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (the kernels) or cpu (their plain versions)")


def synthetic_frames(args, trajectory=synthetic.orbit_trajectory):
    """(camera, ground-truth poses (N, 4, 4), grays (N, H, W), depths (N, H, W))
    rendered on the run's device, 64 sphere-tracing steps per frame."""
    cam = PRESETS[args.camera]
    scale = args.scale
    while scale > 1:
        cam = cam.next_pyramid_level()
        scale //= 2
    poses = trajectory(args.synthetic)
    scene = synthetic.default_scene(args.device)
    out = [synthetic.render(scene, torch.from_numpy(p).to(args.device), cam.fx, cam.fy, cam.cx, cam.cy,
                            cam.height, cam.width, num_steps=64) for p in poses]
    return cam, poses, torch.stack([g for _, g in out]), torch.stack([d for d, _ in out])


def write_mesh(vol, path: str) -> tuple[int, int, float]:
    """Mesh the volume (the marching-cubes kernel), merge its vertices on
    the volume's device, copy the mesh to the host once and write the PLY:
    (vertices, faces, seconds)."""
    t = time.perf_counter()
    verts, faces, cols = (x.cpu().numpy() for x in dedup_triangle_soup(*vol.extract_mesh_tensors()))
    write_ply_mesh(path, verts, faces, colors=cols)
    return len(verts), len(faces), time.perf_counter() - t


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_synthetic_args(ap)
    ap.add_argument("--out-mesh", type=str, default="fused_mesh.ply")
    ap.add_argument("--out-traj", type=str, default="fused_trajectory.txt")
    ap.add_argument("--voxel", type=float, default=0.0125)
    ap.add_argument("--capacity", type=int, default=16384)
    ap.add_argument("--chunk", type=int, default=1, help="frames per process_chunk call")
    args = ap.parse_args()

    cam, gt, grays, depths = synthetic_frames(args)
    slam = FusedDenseFusion(cam, device=args.device, voxel_size=args.voxel, truncation=args.voxel * 8,
                            capacity=args.capacity)
    t0 = time.perf_counter()
    for i in range(0, len(grays), args.chunk):
        slam.process_chunk(grays[i : i + args.chunk], depths[i : i + args.chunk])
    poses, _ = slam.finalize()
    dt = time.perf_counter() - t0
    n = len(poses)
    print(f"fused slam: {n} frames in {dt:.2f}s ({n / dt:.2f} fps), "
          f"{slam.num_active} blocks, overflow {slam.overflow}")
    traj.write_matrix_trajectory(args.out_traj, poses)
    print(f"ATE RMSE ({n} frames): {traj.ate_rmse(poses, np.asarray(gt)[:n]):.5f} m")
    nv, nf, secs = write_mesh(slam.to_volume(), args.out_mesh)
    print(f"mesh: {nv} verts {nf} faces in {secs:.2f}s -> {args.out_mesh}")


if __name__ == "__main__":
    main()
