#!/usr/bin/env python3
"""Convert an Oppo-format capture to the TUM layout (the port's
`tools/oppo_to_tum.py`; ref: example/OppoToTum.cpp), on the port's PNG codec.

    python3 tools/torch_oppo_to_tum.py INPUT_FOLDER OUTPUT_FOLDER

`_info.txt` holds the frame count; frames are `rgbNNNN.png` (1920x1080
colour, centre-cropped to the depth's 960x540 field of view) and
`dNNNN.png` (16-bit depth, scale 1000). Frame i gets the timestamp i / 30
s; `associate.txt` pairs each colour frame with its depth frame. Reading
and writing go through `onepiece_tpu_torch/io/png.py` (8-bit colour,
16-bit depth), so the written pixels are the crop's, as the JAX tool's
cv2 round trip leaves them. A frame that is missing stops the conversion.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from onepiece_tpu_torch.io import png  # noqa: E402

CROP = (270, 480, 540, 960)  # top, left, height, width of the colour crop (ref OppoToTum.cpp roi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input_folder")
    ap.add_argument("output_folder")
    args = ap.parse_args(argv)

    with open(os.path.join(args.input_folder, "_info.txt")) as f:
        n = int(f.read().split()[0])
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(args.output_folder, sub), exist_ok=True)
    assoc = []
    for i in range(n):
        paths = [os.path.join(args.input_folder, name) for name in (f"rgb{i:04d}.png", f"d{i:04d}.png")]
        if not all(os.path.exists(p) for p in paths):
            print(f"missing frame {i}, stopping")
            break
        rgb, depth = png.read_png(paths[0]), png.read_png(paths[1])
        if rgb.shape[:2] == (1080, 1920):
            top, left, h, w = CROP
            rgb = rgb[top : top + h, left : left + w]
        ts = i / 30.0
        rn, dn = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        png.write_png(os.path.join(args.output_folder, rn), np.ascontiguousarray(rgb))
        png.write_png(os.path.join(args.output_folder, dn), depth.astype(np.uint16))
        assoc.append(f"{ts:.6f} {rn} {ts:.6f} {dn}")
    with open(os.path.join(args.output_folder, "associate.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    print(f"converted {len(assoc)} frames -> {args.output_folder}")
    print("intrinsics (ref): fx=914.494 fy=914.378 cx=479.033 cy=274.493, 960x540, scale 1000")
    return 0


if __name__ == "__main__":
    sys.exit(main())
