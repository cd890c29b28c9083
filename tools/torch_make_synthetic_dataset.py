#!/usr/bin/env python3
"""Render the synthetic scene into an on-disk TUM-format dataset, on the port.

    python3 tools/torch_make_synthetic_dataset.py out_dir --frames 30           # 640x480, on the card
    python3 tools/torch_make_synthetic_dataset.py out_dir --frames 4 --scale 8 --device cpu
    python3 tools/torch_make_synthetic_dataset.py out_dir --corrupt --textureless 10:14

The counterpart of `tools/make_synthetic_dataset.py` for
`onepiece_tpu_torch`: renders the synthetic orbit on the device
(`utils/synthetic.render`), optionally applies the sensor model, and writes
`rgb/`, `depth/`, `rgb.txt`, `depth.txt` and `groundtruth.txt` with the
port's own PNG encoder (`io/png.py`). Every `--dataset` tool of either
package reads the folder; no network and no dataset download is needed.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_common import add_device_arg, scaled_camera

from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.io.tum import write_synthetic_tum


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", type=str)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--corrupt", action="store_true", help="apply the sensor model (depth noise + holes + gray noise)")
    ap.add_argument("--textureless", type=str, default=None, metavar="K0:K1",
                    help="collapse contrast on frames [K0, K1) (textureless segment)")
    add_device_arg(ap)
    args = ap.parse_args()

    cam = scaled_camera(TUM_CAMERA, args.scale)
    tl = tuple(int(x) for x in args.textureless.split(":")) if args.textureless else None
    t0 = time.perf_counter()
    write_synthetic_tum(args.out, num_frames=args.frames, camera=cam, corrupt=args.corrupt, textureless=tl,
                        device=args.device)
    tag = " (corrupted)" if args.corrupt else ""
    print(f"wrote {args.frames} frames ({cam.width}x{cam.height}){tag} to {args.out} "
          f"in {time.perf_counter() - t0:.2f}s")


if __name__ == "__main__":
    main()
