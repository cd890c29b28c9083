#!/usr/bin/env python3
"""Inspect meshes, point clouds and RGB-D frames on the PyTorch + CUDA port.

    python3 tools/torch_read_ply.py mesh mesh.ply --preview mesh.png --rewrite copy.ply
    python3 tools/torch_read_ply.py pcd cloud.ply
    python3 tools/torch_read_ply.py rgbd depth/0001.png --rgb rgb/0001.png --rewrite cloud.ply

The counterpart of `tools/read_ply.py` for `onepiece_tpu_torch` (ref
example/{ReadPLYMESH,ReadPLYPCD,ReadRGBD}.cpp): load the file, print a
summary, optionally re-write it (a round-trip check) or render a preview
PNG (`viz/render.save_mesh_png`, on the run's device). The rgbd mode reads
its PNGs with the port's decoder (`io/png.read_png`) and back-projects the
depth into a cloud on the run's device. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_common import add_device_arg  # noqa: E402
from onepiece_tpu_torch.geometry.camera import PRESETS  # noqa: E402
from onepiece_tpu_torch.geometry.pointcloud import PointCloud  # noqa: E402
from onepiece_tpu_torch.io.ply import read_ply, write_ply_mesh, write_ply_pointcloud  # noqa: E402
from onepiece_tpu_torch.io.png import read_png  # noqa: E402
from onepiece_tpu_torch.viz.render import save_mesh_png  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cmd", choices=["mesh", "pcd", "rgbd"])
    ap.add_argument("input", help="PLY path (mesh/pcd) or depth PNG (rgbd)")
    ap.add_argument("--rgb", default="", help="rgb image for rgbd mode")
    ap.add_argument("--rewrite", default="", help="round-trip write to this path")
    ap.add_argument("--preview", default="", help="render preview PNG here")
    ap.add_argument("--camera", default="tum", choices=list(PRESETS))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    cam = PRESETS[args.camera]

    if args.cmd in ("mesh", "pcd"):
        data = read_ply(args.input)
        v = data["vertices"]
        f = data.get("faces")
        print(f"vertices: {len(v)}  bbox {v.min(0).round(3)} .. {v.max(0).round(3)}")
        if data.get("colors") is not None:
            print(f"colors:   yes ({data['colors'].dtype})")
        if data.get("normals") is not None:
            print("normals:  yes")
        if args.cmd == "mesh":
            nf = 0 if f is None else len(f)
            print(f"faces:    {nf}")
            if nf:
                e = v[f[:, 1]] - v[f[:, 0]]
                e2 = v[f[:, 2]] - v[f[:, 0]]
                area = 0.5 * np.linalg.norm(np.cross(e, e2), axis=-1).sum()
                print(f"surface area: {area:.4f} m^2")
        if args.rewrite:
            write_ply_mesh(args.rewrite, v, f if f is not None else np.zeros((0, 3), np.int32),
                           data.get("colors"), data.get("normals"))
            back = read_ply(args.rewrite)
            if not np.allclose(back["vertices"], v, atol=1e-6):
                raise SystemExit(f"round-trip failed: {args.rewrite} reads back other vertices")
            print(f"round-trip ok -> {args.rewrite}")
        if args.preview:
            T = np.eye(4)
            T[:3, 3] = v.mean(0) + np.array([0, 0, -2.0 * max(1e-3, v.std())])
            cols = data.get("colors")
            save_mesh_png(args.preview, torch.from_numpy(v).to(args.device),
                          torch.from_numpy(f if f is not None else np.zeros((0, 3), np.int64)).to(args.device),
                          cam, T, None if cols is None else torch.from_numpy(cols).to(args.device))
            print(f"preview -> {args.preview}")
        return

    # rgbd: depth (+ optional rgb) -> stats + backprojected cloud
    depth = read_png(args.input).astype(np.float32) / cam.depth_scale
    valid = depth > 0
    print(f"depth: {depth.shape} valid {valid.mean() * 100:.1f}% "
          f"range [{depth[valid].min():.3f}, {depth[valid].max():.3f}] m")
    rgb = None
    if args.rgb:
        rgb = read_png(args.rgb).astype(np.float32) / 255.0
        print(f"rgb:   {rgb.shape}")
    cloud = PointCloud.from_rgbd(torch.from_numpy(depth).to(args.device),
                                 None if rgb is None else torch.from_numpy(rgb).to(args.device), cam)
    pts, _, cols = cloud.to_numpy()
    print(f"backprojected cloud: {len(pts)} points")
    if args.rewrite:
        write_ply_pointcloud(args.rewrite, pts, colors=cols if args.rgb else None)
        print(f"cloud -> {args.rewrite}")


if __name__ == "__main__":
    main()
