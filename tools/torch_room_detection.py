#!/usr/bin/env python3
"""Room segmentation on the PyTorch + CUDA port: wall lines, their arrangement, room labels.

    python3 tools/torch_room_detection.py                                  # synthetic 2-room plan, on the card
    python3 tools/torch_room_detection.py cloud.ply --rooms 3 --z-min 0.3 --z-max 2.0
    python3 tools/torch_room_detection.py --device cpu

The counterpart of `tools/room_detection.py` for `onepiece_tpu_torch` (ref
example/RoomDetection.cpp): wall lines by 2-D region growing over the wall
points (kNN and local fits on the run's device), the line arrangement
(`algorithm/dcel.py`, host), wall evidence on its edges, and room labels
from a diffusion embedding and k-means on the run's device
(`algorithm/rooms.py`). Its synthetic plan and subsample are the JAX
tool's (numpy seed 0). Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_common import add_device_arg  # noqa: E402
from onepiece_tpu_torch.algorithm import dcel, rooms  # noqa: E402
from onepiece_tpu_torch.algorithm.patch_detection import detect_patches  # noqa: E402
from onepiece_tpu_torch.io.ply import read_ply  # noqa: E402
from onepiece_tpu_torch.ops.knn import knn  # noqa: E402


def two_room_plan(rng: np.random.Generator) -> np.ndarray:
    """The JAX tool's synthetic wall points (1,000, 2): a 4 x 2 m outer box
    and a dividing wall at x = 0, 1 cm noise."""
    rng.uniform(-1, 1, 400)  # drawn and unused by the JAX tool: keeps its stream
    wall_pts = np.concatenate([
        np.c_[np.zeros(300), rng.uniform(-1, 1, 300)],  # divider x=0
        np.c_[rng.uniform(-2, 2, 200), np.full(200, -1.0)],
        np.c_[rng.uniform(-2, 2, 200), np.full(200, 1.0)],
        np.c_[np.full(100, -2.0), rng.uniform(-1, 1, 100)],
        np.c_[np.full(100, 2.0), rng.uniform(-1, 1, 100)],
    ]).astype(np.float32)
    return wall_pts + rng.normal(0, 0.01, wall_pts.shape).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input", nargs="?", default="",
                    help="PLY cloud; walls projected to XY (default: synthetic 2-room plan)")
    ap.add_argument("--rooms", type=int, default=2)
    ap.add_argument("--z-min", type=float, default=0.3, help="wall band lower z")
    ap.add_argument("--z-max", type=float, default=2.0, help="wall band upper z")
    ap.add_argument("--wall-dist", type=float, default=0.1)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    if args.input:
        v = read_ply(args.input)["vertices"].astype(np.float32)
        wall_pts = v[(v[:, 2] > args.z_min) & (v[:, 2] < args.z_max)][:, :2]
        print(f"wall band: {len(wall_pts)} points")
    else:
        wall_pts = two_room_plan(rng)
        print("synthetic: 2-room floor plan, divider at x=0")

    # wall lines by 2-D region growing over the wall points
    sub = wall_pts[rng.choice(len(wall_pts), min(len(wall_pts), 1500), replace=False)]
    p = torch.from_numpy(sub).to(args.device)
    idx, _ = knn(p, p, torch.ones(len(sub), dtype=torch.bool, device=args.device), k=8)
    patches = detect_patches(p, idx, residual_threshold=0.05, min_points=40)
    lines = [patch.model[:4] for patch in patches]  # (origin 2, dir 2)
    print(f"{len(lines)} wall lines detected")
    if not lines:
        print("no walls found")
        return dict(lines=0, arrangement=None, labels=None)

    lo = wall_pts.min(0) - 0.2
    hi = wall_pts.max(0) + 0.2
    arr = dcel.build_arrangement(np.asarray(lines, float), box_lo=tuple(lo[:2]), box_hi=tuple(hi[:2]))
    print(f"arrangement: {len(arr.faces)} faces")
    labels = rooms.detect_rooms(arr, wall_pts, num_rooms=args.rooms, wall_dist=args.wall_dist, device=args.device)
    for r in np.unique(labels):
        print(f"  room {r}: faces {[i for i in range(len(labels)) if labels[i] == r]}")
    print("PASS" if len(np.unique(labels)) == min(args.rooms, len(arr.faces)) else "WARN: fewer rooms than requested")
    return dict(lines=len(lines), arrangement=arr, labels=labels)


if __name__ == "__main__":
    main()
