#!/usr/bin/env python3
"""Where the time of the PyTorch port's FusedFBASlam (sparse SLAM) or
FusedBASlam (BAFusion: the same front end, the track linker and full BA) goes.

    python3 tools/profile_torch_sparse.py                        # 640x480, 100-frame loop, chunks of 25, cuda
    python3 tools/profile_torch_sparse.py --trajectory orbit --frames 16 --chunk 16
    python3 tools/profile_torch_sparse.py --system ba            # FusedBASlam
    python3 tools/profile_torch_sparse.py --device cpu --level 2 --frames 8 --chunk 4 --max-keypoints 300

Renders the synthetic `loop_trajectory` (or `orbit_trajectory`) at
`TUM_CAMERA.pyramid(level + 1)[level]` (level 0 is 640x480), runs one warm
pass, then measures:

  1. stages of `process_chunk`: features (`extract_sparse_frames_batch`),
     the tracking loop (`FusedFBASlam._frame`, with its failure-ladder read),
     loop-closure candidates (`lc_candidates_device`), loop-closure pair
     tracking (`FusedFBASlam._track` outside the tracking loop), the pose
     graph (`optimize_pose_graph`), the chunk's host reads (`fetch` outside
     the tracking loop), with `--system ba` the track linker
     (`fused_ba.link_edges`) and the LM loop (`bundle.optimize_device`),
     and the rest; each call timed on the host clock
     from a drained device queue to a drained one (a call made inside
     another stage counts in that stage); total ms, calls, ms per frame;
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
from onepiece_tpu_torch.systems import fused_ba
from onepiece_tpu_torch.systems import fused_sparse as fs
from onepiece_tpu_torch.utils import synthetic
from profile_torch_slice import _sync, _union_us, count_syncs

# stage -> (object, attribute) of the function process_chunk calls for it
STAGES = {
    "features": (fs.sparse, "extract_sparse_frames_batch"),
    "tracking loop": (fs.FusedFBASlam, "_frame"),
    "LC candidates": (fs.mild, "lc_candidates_device"),
    "LC pair tracking": (fs.FusedFBASlam, "_track"),
    "pose graph": (fs.posegraph, "optimize_pose_graph"),
    "chunk host reads": (fs, "fetch"),
}
BA_STAGES = {
    "track linker": (fused_ba, "link_edges"),
    "LM loop": (fused_ba.bundle, "optimize_device"),
}


@contextlib.contextmanager
def timing_stages(dev: torch.device, totals: dict, calls: dict, stages: dict):
    """Wrap every stage's function: each outermost call adds its synced host ms."""
    saved, active = [], []

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            if active:  # inside another stage: counted there
                return fn(*args, **kwargs)
            active.append(name)
            _sync(dev)
            t = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                _sync(dev)
            finally:
                active.pop()
            totals[name] += (time.perf_counter() - t) * 1e3
            calls[name] += 1
            return out
        return wrapped

    for name, (obj, attr) in stages.items():
        totals[name], calls[name] = 0.0, 0
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    try:
        yield
    finally:
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)


def run(make, grays, depths, chunk: int) -> float:
    """One FusedFBASlam pass; host ms from a drained queue to a drained one."""
    slam = make()
    _sync(slam.device)
    t = time.perf_counter()
    for i in range(0, len(grays), chunk):
        slam.process_chunk(grays[i : i + chunk], depths[i : i + chunk])
    _sync(slam.device)
    return (time.perf_counter() - t) * 1e3


def stage_times(make, grays, depths, chunk: int, stages: dict) -> dict:
    totals, calls = {}, {}
    with timing_stages(make().device, totals, calls, stages):
        wall = run(make, grays, depths, chunk)
    totals["rest of process_chunk"] = wall - sum(totals.values())
    calls["rest of process_chunk"] = -(-len(grays) // chunk)
    return {"wall_ms": wall, "ms": totals, "calls": calls}


def profile_run(make, grays, depths, chunk: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    dev = make().device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        wall_ms = run(make, grays, depths, chunk)
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
    ap.add_argument("--system", choices=("fba", "ba"), default="fba", help="FusedFBASlam or FusedBASlam")
    ap.add_argument("--trajectory", choices=("loop", "orbit"), default="loop")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--level", type=int, default=0, help="TUM_CAMERA pyramid level (0 = 640x480)")
    ap.add_argument("--max-keypoints", type=int, default=1000)
    ap.add_argument("--render-steps", type=int, default=64)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("profile_torch_sparse: torch.cuda.is_available() is False", file=sys.stderr)
            return 1
        _build.library()
    cam = TUM_CAMERA.pyramid(args.level + 1)[args.level]
    scene = synthetic.default_scene(dev)
    traj_fn = synthetic.loop_trajectory if args.trajectory == "loop" else synthetic.orbit_trajectory
    frames = [
        synthetic.render(scene, torch.from_numpy(p).to(dev), cam.fx, cam.fy, cam.cx, cam.cy,
                         cam.height, cam.width, num_steps=args.render_steps)
        for p in traj_fn(args.frames)
    ]
    depths = torch.stack([d for d, _ in frames])
    grays = torch.stack([g for _, g in frames])

    system = fused_ba.FusedBASlam if args.system == "ba" else fs.FusedFBASlam
    stages = {**STAGES, **BA_STAGES} if args.system == "ba" else STAGES

    def make():
        return system(cam, device=dev, max_keypoints=args.max_keypoints)

    run(make, grays, depths, args.chunk)  # warm: kernel library, allocator, solver handles
    syncs = count_syncs(dev, lambda: run(make, grays, depths, args.chunk))
    out = {
        "system": args.system,
        "size": f"{cam.width}x{cam.height}",
        "trajectory": args.trajectory,
        "frames": args.frames,
        "chunk": args.chunk,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "stages": stage_times(make, grays, depths, args.chunk, stages),
        "host_sync_sites": syncs,
        "host_syncs_per_frame": sum(syncs.values()) / args.frames if syncs is not None else None,
        "profile": profile_run(make, grays, depths, args.chunk),
    }
    st = out["stages"]
    for name, ms in st["ms"].items():
        print(f"{name:24s} {ms:10.2f} ms in {st['calls'][name]:4d} calls  "
              f"{100 * ms / st['wall_ms']:5.1f} %  ({ms / args.frames:.3f} ms/frame)")
    print(f"run: {st['wall_ms']:.1f} ms, {st['wall_ms'] / args.frames:.3f} ms/frame")
    print(f"host syncs by site: {out['host_sync_sites']}")
    print(f"profile: {out['profile']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
