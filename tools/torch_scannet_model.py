#!/usr/bin/env python3
"""GenerateModelFromScannet on the PyTorch + CUDA port: a ground-truth-pose
TSDF reconstruction of a ScanNet export, written as a PLY mesh.

    python3 tools/torch_scannet_model.py ROOT [OUT.ply] [--voxel 0.02] [--stride 10] [--max-frames N]
    python3 tools/torch_scannet_model.py ROOT out.ply --stride 1 --device cpu   # the plain versions

The counterpart of `tools/scannet_model.py` (ref
example/GenerateModelFromScannet.cpp). ROOT holds `_info.txt` and
`frame-XXXXXX.{color.jpg,depth.pgm,pose.txt}`, read by `io/scannet.py`
(the port's JPEG and PGM readers; colour resampled onto the depth grid).
Every `stride`-th frame whose pose is finite (ScanNet marks untracked
frames with -inf) is bilateral-filtered and fused by `TSDFVolume.integrate`
(the TSDF kernel, rgb form, one launch a frame) at its pose; then the
marching-cubes kernel meshes every block, the vertices are merged on the
device and the PLY is written. Unlike the JAX tool's volume, the port's
masks no block for spanning many image rows and caps no chunk's triangles.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_common import add_device_arg, write_mesh

import numpy as np  # noqa: E402
import torch  # noqa: E402

from onepiece_tpu_torch.integration.blocks import TSDFVolume  # noqa: E402
from onepiece_tpu_torch.io.scannet import ScanNetSequence  # noqa: E402
from onepiece_tpu_torch.ops.image import bilateral_filter  # noqa: E402


def reconstruct(root: str, voxel: float = 0.02, stride: int = 10, max_frames: int | None = None,
                device: str = "cuda", log=print) -> tuple[TSDFVolume, int]:
    """Fuse every `stride`-th frame with a finite pose: (volume, frames used)."""
    seq = ScanNetSequence(root, max_frames)
    cam = seq.camera
    log(f"{len(seq)} frames, depth camera {cam.width}x{cam.height}")
    vol = TSDFVolume(voxel_size=voxel, truncation=voxel * 5, device=device)
    scale = torch.tensor(255.0, device=device)  # a device divisor: the quotient is numpy's on every device
    used = 0
    for i in range(0, len(seq), stride):
        _, rgb, depth, pose = seq[i]
        if not np.isfinite(pose).all():
            continue
        d = bilateral_filter(torch.from_numpy(depth).to(device))
        colour = None if rgb is None else torch.from_numpy(rgb).to(device).float() / scale
        vol.integrate(d, colour, pose.astype(np.float32), cam)
        used += 1
        if used % 10 == 0:
            log(f"  frame {i}: {vol.num_active} active blocks")
    return vol, used


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", help="ScanNet export dir (with _info.txt)")
    ap.add_argument("output", nargs="?", default="scannet_model.ply")
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--stride", type=int, default=10)
    ap.add_argument("--max-frames", type=int, default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    vol, used = reconstruct(args.root, args.voxel, args.stride, args.max_frames, args.device)
    print(f"integrated {used} frames, {vol.num_active} blocks, "
          f"{vol.key_saturated_frames} frames filled the key pass (max_blocks {vol.max_blocks})")
    nv, nf, secs = write_mesh(vol, args.output)
    print(f"mesh: {nv} verts {nf} faces in {secs:.2f}s -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
