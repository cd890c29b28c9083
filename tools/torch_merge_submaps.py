#!/usr/bin/env python3
"""Merge TSDF submap volumes under per-submap poses, on the PyTorch + CUDA port.

    python3 tools/torch_merge_submaps.py a.npz b.npz --trajectory poses.txt [--device cpu]

The counterpart of `tools/merge_submaps.py` for `onepiece_tpu_torch`: loads
submap volumes (`volume_ops.save_volume` npz, written by either package),
transforms each into the global frame (16-float-row world-from-submap
poses), merges them voxel-wise and meshes the result (the marching-cubes
kernel on the card, then the vertex dedup on the volume's device). Imports
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_common import write_mesh

from onepiece_tpu_torch.integration import volume_ops
from onepiece_tpu_torch.io import trajectory as traj


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("volumes", nargs="+", help="submap .npz files")
    ap.add_argument("--trajectory", required=True, help="16-float-row poses, one per submap (world-from-submap)")
    ap.add_argument("--out-mesh", default="merged.ply")
    ap.add_argument("--out-volume", default="")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    poses = traj.read_matrix_trajectory(args.trajectory)
    if len(poses) < len(args.volumes):
        ap.error(f"{len(args.volumes)} volumes but {len(poses)} poses")
    merged = None
    for i, path in enumerate(args.volumes):
        vol = volume_ops.load_volume(path, args.device)
        print(f"submap {i}: {vol.num_active} blocks")
        moved = volume_ops.transform_volume(vol, poses[i])
        merged = moved if merged is None else volume_ops.merge_volumes(merged, moved)
    print(f"merged: {merged.num_active} blocks")
    if args.out_volume:
        volume_ops.save_volume(merged, args.out_volume)
    nv, nf, _ = write_mesh(merged, args.out_mesh)
    print(f"mesh: {nv} verts {nf} faces -> {args.out_mesh}")


if __name__ == "__main__":
    main()
