#!/usr/bin/env python3
"""Where the time of the PyTorch port's DenseSlam goes.

    python3 tools/profile_torch_dense_slam.py       # 640x480, 150 frames, cuda
    python3 tools/profile_torch_dense_slam.py --device cpu --level 3 --frames 12 --submap-size 4

Renders `loop_trajectory` at `TUM_CAMERA.pyramid(level + 1)[level]` (level
0 is 640x480), runs one warm `DenseSlam` pass, then measures:

  1. layers: tracking (`preprocess_frame` + `dense_tracking`), submap fuse
     + downsample (`merge`, `voxel_downsample`, `compact`), normals + FPFH
     (`extract_features`), ICP (`icp.point_to_point`), RANSAC
     (`global_reg.register`), pose graph (`_optimize`), and the rest of
     `update_frame`; each call timed on the host clock from a drained
     device queue to a drained one; total ms, calls, and share of the run;
  2. host syncs (CUDA only): synchronizing operations counted with
     `torch.cuda.set_sync_debug_mode("warn")`, by the line that made them;
  3. one profiled run (`torch.profiler`): device operations, device busy
     time (union of the device events) and its share of the profiled wall.

A number the run could not measure (device time on a CPU run) is printed
as null. The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from onepiece_tpu_torch import _build
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.systems import dense_slam as ds
from onepiece_tpu_torch.utils import synthetic
from profile_torch_slice import _sync, _union_us, count_syncs

# layer -> (object, attribute) of the functions DenseSlam calls for it
LAYERS = {
    "tracking": [(ds.dense, "preprocess_frame"), (ds.dense, "dense_tracking")],
    "submap fuse + downsample": [(ds, "merge"), (ds, "voxel_downsample"), (ds, "compact")],
    "normals + FPFH": [(ds.global_reg, "extract_features")],
    "ICP": [(ds.icp, "point_to_point")],
    "RANSAC": [(ds.global_reg, "register")],
    "pose graph": [(ds.DenseSlam, "_optimize")],
}


@contextlib.contextmanager
def timing_layers(dev: torch.device, totals: dict, calls: dict):
    """Wrap every layer's functions: each call adds its synced host ms."""
    saved = []

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            _sync(dev)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(dev)
            totals[name] += (time.perf_counter() - t) * 1e3
            calls[name] += 1
            return out
        return wrapped

    for name, sites in LAYERS.items():
        totals[name], calls[name] = 0.0, 0
        for obj, attr in sites:
            saved.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, timed(name, getattr(obj, attr)))
    try:
        yield
    finally:
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)


def run(make, grays, depths) -> float:
    """One DenseSlam pass; host ms from a drained queue to a drained one."""
    slam = make()
    _sync(slam.device)
    t = time.perf_counter()
    for g, d in zip(grays, depths):
        slam.update_frame(g, d)
    _sync(slam.device)
    return (time.perf_counter() - t) * 1e3


def layer_times(make, grays, depths) -> dict:
    totals, calls = {}, {}
    with timing_layers(make().device, totals, calls):
        wall = run(make, grays, depths)
    totals["rest of update_frame"] = wall - sum(totals.values())
    calls["rest of update_frame"] = len(grays)
    return {"wall_ms": wall, "ms": totals, "calls": calls}


def profile_run(make, grays, depths) -> dict:
    from torch.profiler import ProfilerActivity, profile

    dev = make().device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        wall_ms = run(make, grays, depths)
    on_dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in on_dev]) / 1e3 if on_dev else None
    return {
        "wall_ms": wall_ms,
        "device_ops": len(on_dev) if on_dev else None,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if on_dev else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--level", type=int, default=0, help="TUM_CAMERA pyramid level (0 = 640x480)")
    ap.add_argument("--submap-size", type=int, default=ds.SUBMAP_SIZE)
    ap.add_argument("--render-steps", type=int, default=64)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("profile_torch_dense_slam: torch.cuda.is_available() is False", file=sys.stderr)
            return 1
        _build.library()
    cam = TUM_CAMERA.pyramid(args.level + 1)[args.level]
    scene = synthetic.default_scene(dev)
    frames = [
        synthetic.render(scene, torch.from_numpy(p).to(dev), cam.fx, cam.fy, cam.cx, cam.cy,
                         cam.height, cam.width, num_steps=args.render_steps)
        for p in synthetic.loop_trajectory(args.frames)
    ]
    depths = torch.stack([d for d, _ in frames])
    grays = torch.stack([g for _, g in frames])

    def make():
        return ds.DenseSlam(cam, dev, submap_size=args.submap_size)

    run(make, grays, depths)  # warm: kernel library, allocator, solver handles
    out = {
        "size": f"{cam.width}x{cam.height}",
        "frames": args.frames,
        "submap_size": args.submap_size,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "layers": layer_times(make, grays, depths),
        "host_sync_sites": count_syncs(dev, lambda: run(make, grays, depths)),
        "profile": profile_run(make, grays, depths),
    }
    lay = out["layers"]
    for name, ms in lay["ms"].items():
        print(f"{name:26s} {ms:10.2f} ms in {lay['calls'][name]:4d} calls  "
              f"{100 * ms / lay['wall_ms']:5.1f} %  ({ms / args.frames:.3f} ms/frame)")
    print(f"run: {lay['wall_ms']:.1f} ms, {lay['wall_ms'] / args.frames:.3f} ms/frame")
    print(f"host syncs by site: {out['host_sync_sites']}")
    print(f"profile: {out['profile']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
