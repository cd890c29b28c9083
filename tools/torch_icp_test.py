#!/usr/bin/env python3
"""Align two point clouds with ICP (the port's `tools/icp_test.py`).

    python3 tools/torch_icp_test.py --synthetic [--mode plane]
    python3 tools/torch_icp_test.py source.ply target.ply --out aligned.ply

Reads two PLY files (or makes the seeded synthetic pair: 3,000 points of a
wavy surface and a known rigid motion), runs point-to-point or
point-to-plane ICP (`registration/icp.py`: on the card each correspondence
pass is the nn1 kernel), prints the transform, inliers and rmse, and with a
known motion the largest |T - T_gt|; optionally writes the aligned source.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_common import add_device_arg  # noqa: E402
from onepiece_tpu_torch.geometry import se3  # noqa: E402
from onepiece_tpu_torch.geometry.pointcloud import PointCloud, estimate_normals  # noqa: E402
from onepiece_tpu_torch.io.ply import read_ply, write_ply_pointcloud  # noqa: E402
from onepiece_tpu_torch.registration import icp  # noqa: E402

XI_GT = (0.05, -0.03, 0.04, 0.05, -0.04, 0.06)  # the synthetic pair's motion (twist)


def synthetic_pair() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(source (3000, 3), target = T_gt source, T_gt (4, 4)), float32."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-1, 1, size=(3000, 2))
    z = 0.3 * np.sin(2.5 * xy[:, 0]) + 0.2 * np.cos(3.1 * xy[:, 1])
    src = np.c_[xy, z].astype(np.float32)
    T_gt = se3.se3_exp(torch.tensor(XI_GT, dtype=torch.float32)).numpy()
    return src, src @ T_gt[:3, :3].T + T_gt[:3, 3], T_gt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source", nargs="?", default="")
    ap.add_argument("target", nargs="?", default="")
    ap.add_argument("--mode", choices=["point", "plane"], default="point")
    ap.add_argument("--threshold", type=float, default=icp.DEFAULT_THRESHOLD)
    ap.add_argument("--iters", type=int, default=icp.DEFAULT_ITERS)
    ap.add_argument("--out", default="")
    ap.add_argument("--synthetic", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    if args.synthetic or not args.source:
        src_pts, tgt_pts, T_gt = synthetic_pair()
        print("synthetic pair; ground truth transform known")
    else:
        src_pts, tgt_pts, T_gt = read_ply(args.source)["vertices"], read_ply(args.target)["vertices"], None
    src = PointCloud.from_numpy(src_pts, device=args.device)
    tgt = PointCloud.from_numpy(tgt_pts, device=args.device)
    if args.mode == "plane":
        tgt = estimate_normals(tgt, k=16)
        res = icp.point_to_plane(src.points, src.valid, tgt.points, tgt.normals, tgt.valid,
                                 threshold=args.threshold, iters=args.iters)
    else:
        res = icp.point_to_point(src.points, src.valid, tgt.points, tgt.valid,
                                 threshold=args.threshold, iters=args.iters)
    T = res.T.cpu().numpy()
    out = dict(T=T, inliers=int(res.num_inliers), rmse=float(res.rmse))
    print("T =\n", T)
    print(f"inliers {out['inliers']} rmse {out['rmse']:.6f}")
    if T_gt is not None:
        out["max_err"] = float(np.abs(T - T_gt).max())
        print("max |T - T_gt| =", out["max_err"])
    if args.out:
        write_ply_pointcloud(args.out, src_pts @ T[:3, :3].T + T[:3, 3])
        print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
