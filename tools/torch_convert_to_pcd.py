#!/usr/bin/env python3
"""An RGB-D sequence to one fused, coloured point cloud PLY (the port's
`tools/convert_to_pcd.py`).

    python3 tools/torch_convert_to_pcd.py --dataset DIR --out cloud.ply       # on the card
    python3 tools/torch_convert_to_pcd.py --synthetic 8 --scale 8 --device cpu

Every `--stride`-th frame is back-projected with its colours (gray as r = g
= b, `PointCloud.from_rgbd`), moved to the world by its ground-truth pose
where the sequence has one, and merged; the merged cloud is
voxel-downsampled (`--voxel`), compacted and written as a PLY.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_common import add_dataset_args, load_frames  # noqa: E402
from onepiece_tpu_torch.geometry.pointcloud import PointCloud, compact, merge, voxel_downsample  # noqa: E402
from onepiece_tpu_torch.io.ply import write_ply_pointcloud  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_dataset_args(ap)
    ap.add_argument("--out", default="cloud.ply")
    ap.add_argument("--stride", type=int, default=5)
    ap.add_argument("--voxel", type=float, default=0.02)
    args = ap.parse_args(argv)

    frames, cam, gt = load_frames(args)
    clouds = []
    for i, (_, gray, depth) in enumerate(frames):
        if i % args.stride:
            continue
        gray = torch.as_tensor(gray, dtype=torch.float32).to(args.device)
        cloud = PointCloud.from_rgbd(torch.as_tensor(depth, dtype=torch.float32).to(args.device),
                                     gray[..., None].expand(-1, -1, 3), cam)
        if gt is not None and i < len(gt):
            cloud = cloud.transform(torch.as_tensor(gt[i], dtype=torch.float32).to(args.device))
        clouds.append(cloud)
    pts, _, cols = compact(voxel_downsample(merge(*clouds), args.voxel)).to_numpy()
    write_ply_pointcloud(args.out, pts, colors=cols)
    print(f"wrote {len(pts)} points -> {args.out}")
    return dict(points=len(pts), clouds=len(clouds))


if __name__ == "__main__":
    main()
