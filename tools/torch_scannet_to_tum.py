#!/usr/bin/env python3
"""ScannetToTum on the PyTorch + CUDA port: convert a ScanNet export to the
TUM dataset layout.

    python3 tools/torch_scannet_to_tum.py ROOT OUT [--max-frames N]

The counterpart of `tools/scannet_to_tum.py` (ref example/ScannetToTum.cpp),
over `io/scannet.scannet_to_tum`: frame i gets the timestamp i / 30 s, its
colour resampled onto the depth grid as `rgb/<ts>.png`, its depth at
scale 5000 as `depth/<ts>.png` (written by the port's PNG codec), and its
pose as a line of `groundtruth.txt`. A frame with a non-finite pose stops
the conversion with an error naming it. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from onepiece_tpu_torch.io.scannet import scannet_to_tum  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", help="ScanNet export dir (with _info.txt)")
    ap.add_argument("out", help="output TUM-format dir")
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args(argv)

    scannet_to_tum(args.root, args.out, args.max_frames)
    print(f"TUM dataset -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
