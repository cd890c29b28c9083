#!/usr/bin/env python3
"""Convert TSDF volumes between the npz format and the C++ reference's
binary cube format, or mesh them (the port's `tools/convert_tsdf.py`).

    python3 tools/torch_convert_tsdf.py volume.npz out.cube   # npz -> reference
    python3 tools/torch_convert_tsdf.py ref.cube out.npz      # reference -> npz
    python3 tools/torch_convert_tsdf.py ref.cube mesh.ply     # reference (or npz) -> mesh

The npz is `integration/volume_ops.save_volume`'s, which both packages read
and write; the cube format is `io/ref_tsdf.py`'s. A .cube file carries no
voxel size or truncation: `--voxel` and `--truncation` give them. The mesh
goes through the marching-cubes kernel and the vertex dedup on the card
(`_torch_common.write_mesh`).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_common import add_device_arg, write_mesh  # noqa: E402
from onepiece_tpu_torch.integration.volume_ops import load_volume, save_volume  # noqa: E402
from onepiece_tpu_torch.io.ref_tsdf import read_ref_tsdf, write_ref_tsdf  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--voxel", type=float, default=0.0125)
    ap.add_argument("--truncation", type=float, default=0.1)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    if args.src.endswith(".npz"):
        vol = load_volume(args.src, device=args.device)
    else:
        vol = read_ref_tsdf(args.src, args.voxel, args.truncation, device=args.device)
    print(f"loaded {vol.num_active} blocks from {args.src}")
    if args.dst.endswith(".npz"):
        save_volume(vol, args.dst)
    elif args.dst.endswith(".ply"):
        nv, nf, secs = write_mesh(vol, args.dst)
        print(f"mesh: {nv} verts {nf} faces in {secs:.2f}s")
    else:
        write_ref_tsdf(args.dst, vol)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
