#!/usr/bin/env python3
"""This tree's PNG decoder against another tree's, on the frames of a TUM folder.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/compare_torch_png.py --parent build/parent [--rounds 5]
    python3 tools/compare_torch_png.py --parent . --frames 2 --scale 8 --device cpu

Writes the synthetic orbit (`--frames` frames, rendered on `--device`) as a
TUM folder with this tree's `io/tum.write_synthetic_tum`, reads every PNG
file into memory, then decodes the frames in turns (other, this, this,
other, per round), `BATCH` = 8 frames' depth and colour PNGs to one
`decode_many` call, as the reader decoded them before the prefetch ring.
Both decoders' images must be equal. Prints host ms per frame (depth +
colour) of each round and the medians, the host's decoding only, no file
reads; on a CUDA device also the card's name and power limit. The other tree's `io/png.py` is loaded
from its file (it imports only the standard library and numpy). One JSON
line of the results last.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from onepiece_tpu_torch.geometry.camera import TUM_CAMERA  # noqa: E402
from onepiece_tpu_torch.io import png, tum  # noqa: E402

BATCH = 8  # frames a decode_many call


def load_png(tree: str):
    spec = importlib.util.spec_from_file_location("other_png", Path(tree) / "onepiece_tpu_torch" / "io" / "png.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="the other tree's root")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--scale", type=int, default=1, help="camera pyramid level 2^k -> downscale factor")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cam = TUM_CAMERA
    while args.scale > 1:
        cam, args.scale = cam.next_pyramid_level(), args.scale // 2
    with tempfile.TemporaryDirectory(prefix="compare_png_") as root:
        tum.write_synthetic_tum(root, num_frames=args.frames, camera=cam, device=args.device)
        seq = tum.TumSequence(root, depth_scale=cam.depth_scale)
        datas = [[(Path(root) / p).read_bytes() for _, *ps in seq.pairs[at : at + BATCH] for p in ps]
                 for at in range(0, len(seq.pairs), BATCH)]
    decoders = {"other": load_png(args.parent).decode_many, "this": png.decode_many}

    def timed(name: str) -> float:
        t = time.perf_counter()
        out = [decoders[name](batch) for batch in datas]
        ms = (time.perf_counter() - t) * 1e3 / args.frames
        want = [png.decode_many(batch) for batch in datas] if name == "other" else out
        if not all(np.array_equal(a, b) for x, y in zip(out, want) for a, b in zip(x, y)):
            raise AssertionError("the two decoders' images differ")
        return ms

    ms = {"other": [], "this": []}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            ms[name].append(timed(name))
    card = None
    if args.device != "cpu":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip().splitlines()[0]
        print(card)
    out = dict(frames=args.frames, width=cam.width, height=cam.height, card=card,
               ms_per_frame=ms, median={k: float(np.median(v)) for k, v in ms.items()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
