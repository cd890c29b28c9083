#!/usr/bin/env python3
"""Live-capture driver: a live RGB-D stream into FusedDenseFusion, with the
frames optionally re-recorded (the port's `tools/acquire_live_data.py`).

    python3 tools/torch_acquire_live_data.py --replay DIR --frames 30 [--out rec_dir]
    python3 tools/torch_acquire_live_data.py --replay DIR --frames 4 --scale 8 --device cpu

The stream is a `io/openni.LiveRGBDReader`; here the sensor-rate
`ReplayRGBDReader` of a TUM folder at `--rate` Hz. Each frame's gray is the
JAX tool's float luma of its colour image, (0.299 r + 0.587 g + 0.114 b) /
255, and the frames go to `FusedDenseFusion` in chunks of `--chunk` as they
arrive. With `--out` each frame is written back as rgb/ and depth/ PNGs
(the port's encoder; depth x 5000 as 16 bits). Prints the wall time, which
the replay clock bounds from below, the largest tracking rmse and the
blocks fused.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from _torch_common import add_device_arg, scaled_camera  # noqa: E402
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA  # noqa: E402
from onepiece_tpu_torch.io import png  # noqa: E402
from onepiece_tpu_torch.io.openni import ReplayRGBDReader  # noqa: E402
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--replay", type=str, required=True, help="TUM dir to replay as a live stream")
    ap.add_argument("--rate", type=float, default=30.0)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--out", type=str, default="", help="archive captured frames to this dir")
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--scale", type=int, default=1, help="the replayed frames' downscale of the TUM camera")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    reader = ReplayRGBDReader(args.replay, rate_hz=args.rate, max_frames=args.frames)
    if not reader.init():
        raise SystemExit(f"no frames in {args.replay}")
    if args.out:
        os.makedirs(os.path.join(args.out, "rgb"), exist_ok=True)
        os.makedirs(os.path.join(args.out, "depth"), exist_ok=True)
    slam = FusedDenseFusion(scaled_camera(TUM_CAMERA, args.scale), device=args.device)
    buf_g, buf_d = [], []
    n = 0
    t0 = time.perf_counter()
    while (item := reader.get_next_rgbd()) is not None:
        ts, rgb, depth = item
        buf_g.append(((0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]) / 255.0).astype(np.float32))
        buf_d.append(depth)
        if args.out:
            png.write_png(os.path.join(args.out, "rgb", f"{ts:.6f}.png"), rgb)
            png.write_png(os.path.join(args.out, "depth", f"{ts:.6f}.png"), (depth * 5000.0).astype(np.uint16))
        n += 1
        if len(buf_g) >= args.chunk:
            slam.process_chunk(np.stack(buf_g), np.stack(buf_d))
            buf_g, buf_d = [], []
    if buf_g:
        slam.process_chunk(np.stack(buf_g), np.stack(buf_d))
    poses, rmses = slam.finalize()
    dt = time.perf_counter() - t0
    reader.close()
    out = dict(frames=n, seconds=dt, max_rmse=float(np.max(rmses)), blocks=slam.num_active, poses=poses)
    print(f"captured {n} frames at {args.rate} Hz in {dt:.1f}s; tracked rmse max {out['max_rmse']:.4f}; "
          f"blocks {out['blocks']}")
    return out


if __name__ == "__main__":
    main()
