#!/usr/bin/env python3
"""Plane patches in a point cloud by region growing, on the PyTorch + CUDA port.

    python3 tools/torch_detect_plane.py                                    # synthetic 3-plane corner, on the card
    python3 tools/torch_detect_plane.py cloud.ply planes.ply --knn 12 --max-points 30000
    python3 tools/torch_detect_plane.py --device cpu

The counterpart of `tools/detect_plane.py` for `onepiece_tpu_torch` (ref
example/DetectPlane.cpp): the kNN (`ops/knn.knn`) and the per-point local
fits on the run's device, the region growing on the host
(`algorithm/patch_detection.py`); prints each patch and writes the cloud
coloured by patch. Its synthetic corner and subsample are the JAX tool's
(numpy seed 0). Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_common import add_device_arg  # noqa: E402
from onepiece_tpu_torch.algorithm.patch_detection import detect_patches  # noqa: E402
from onepiece_tpu_torch.io.ply import read_ply, write_ply_pointcloud  # noqa: E402
from onepiece_tpu_torch.ops.knn import knn  # noqa: E402

PATCH_RGB = np.asarray(
    [[230, 25, 75], [60, 180, 75], [0, 130, 200], [255, 225, 25],
     [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230]],
    np.float32,
) / 255.0


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input", nargs="?", default="", help="PLY cloud (default: synthetic 3-plane corner)")
    ap.add_argument("output", nargs="?", default="planes.ply")
    ap.add_argument("--knn", type=int, default=10)
    ap.add_argument("--residual", type=float, default=0.02)
    ap.add_argument("--min-points", type=int, default=50)
    ap.add_argument("--max-points", type=int, default=4000, help="random subsample cap")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    if args.input:
        pts = read_ply(args.input)["vertices"].astype(np.float32)
    else:
        # synthetic room corner: 3 mutually perpendicular planes
        a = np.c_[rng.uniform(0, 2, (500, 2)), np.zeros(500)]  # floor z=0
        b = np.c_[rng.uniform(0, 2, 500), np.zeros(500), rng.uniform(0, 2, 500)]  # wall y=0
        c = np.c_[np.zeros(500), rng.uniform(0, 2, (500, 2))]  # wall x=0
        pts = np.concatenate([a, b, c]).astype(np.float32)
        pts += rng.normal(0, 0.003, pts.shape).astype(np.float32)
        print("synthetic: 3-plane corner, 1500 points")
    if len(pts) > args.max_points:
        pts = pts[rng.choice(len(pts), args.max_points, replace=False)]

    t = time.perf_counter()
    p = torch.from_numpy(pts).to(args.device)
    idx, _ = knn(p, p, torch.ones(len(pts), dtype=torch.bool, device=args.device), k=args.knn)
    patches = detect_patches(p, idx, residual_threshold=args.residual, min_points=args.min_points)
    print(f"{len(patches)} plane patches over {len(pts)} points in {time.perf_counter() - t:.2f}s")
    colors = np.full((len(pts), 3), 0.4, np.float32)
    for i, patch in enumerate(patches):
        n = patch.model[:3] / np.linalg.norm(patch.model[:3])
        print(f"  patch {i}: {len(patch.indices)} pts, normal=({n[0]:+.2f}, {n[1]:+.2f}, {n[2]:+.2f})")
        colors[patch.indices] = PATCH_RGB[i % len(PATCH_RGB)]
    write_ply_pointcloud(args.output, pts, colors=colors)
    print(f"labeled cloud -> {args.output}")
    return patches


if __name__ == "__main__":
    main()
