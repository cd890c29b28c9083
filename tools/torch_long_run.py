#!/usr/bin/env python3
"""Sustained run around a closed loop: both device-resident systems on 200+
frames (the port's `tools/long_run.py`).

    python3 tools/torch_long_run.py [--frames 200]                 # on the card
    python3 tools/torch_long_run.py --frames 4 --chunk 2 --scale 8 --device cpu --out o.json --metrics m.jsonl

Renders `synthetic.loop_trajectory(frames)` once, then runs on the same
frames:

  1. `FusedDenseFusion(capacity=8192, table_size=2**15)` in chunks of
     `--chunk`, `maybe_grow` between chunks (pool pressure and growth);
  2. `FusedFBASlam` in the same chunks (keyframe database growth, loop
     closure on the return leg, the pose graph).

Each system runs once on a throwaway instance (allocator, kernels, library
handles), then a fresh instance is timed over the whole sequence; both
times are reported. Fails unless the fused pool never overflowed, the FBA
edge store never overflowed, and, at the full 640x480 camera, the FBA ATE
is at most 1.2 x the reference CPU build's 22.8 mm (the JAX tool's drift
gate, whose run is always 640x480; at a reduced `--scale` the FBA front
end finds too few corners to track, so the ATE is printed beside the bar,
not held to it). Writes a summary JSON (`--out`) and the per-chunk metrics
as JSONL (`--metrics`); the defaults are not the JAX run's record files
(`LONGRUN.json`, `longrun_metrics.jsonl`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_common import add_device_arg, scaled_camera  # noqa: E402
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA  # noqa: E402
from onepiece_tpu_torch.io import trajectory as traj  # noqa: E402
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion  # noqa: E402
from onepiece_tpu_torch.systems.fused_sparse import FusedFBASlam  # noqa: E402
from onepiece_tpu_torch.utils import synthetic  # noqa: E402

MAX_FBA_ATE_M = 0.0228 * 1.2  # tools/long_run.py's gate: the reference CPU build's long-run ATE + 20 %


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--out", type=str, default="LONGRUN_torch.json")
    ap.add_argument("--metrics", type=str, default="longrun_torch_metrics.jsonl")
    ap.add_argument("--scale", type=int, default=1, help="downscale factor of camera and render (power of 2)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cam = scaled_camera(TUM_CAMERA, args.scale)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n, ck = args.frames, args.chunk
    scene = synthetic.default_scene(dev)
    poses = synthetic.loop_trajectory(n)
    t0 = time.perf_counter()
    rendered = [synthetic.render(scene, torch.from_numpy(p).to(dev), cam.fx, cam.fy, cam.cx, cam.cy, cam.height,
                                 cam.width, num_steps=64) for p in poses]
    depths = torch.stack([d for d, _ in rendered])
    grays = torch.stack([g for _, g in rendered])
    del rendered
    sync()
    print(f"rendered {n} frames in {time.perf_counter() - t0:.1f}s", flush=True)
    metrics = []

    # ---- 1. the fused dense loop with pool growth ----
    def run_dense(record: bool):
        slam = FusedDenseFusion(cam, capacity=8192, table_size=1 << 15, device=dev)
        grew = 0
        for s in range(0, n, ck):
            slam.process_chunk(grays[s : s + ck], depths[s : s + ck])
            grew += slam.maybe_grow()
            if record:
                metrics.append({"system": "fused", "frame": min(s + ck, n), "active_blocks": slam.num_active,
                                "capacity": slam.capacity, "overflow": slam.overflow})
        est, rmses = slam.finalize()
        sync()
        return slam, est, rmses, grew

    t0 = time.perf_counter()
    run_dense(record=False)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slam, est, rmses, grew = run_dense(record=True)
    dt = time.perf_counter() - t0
    fused = {
        "fps": n / dt, "ate_rmse_m": float(traj.ate_rmse(est, poses)), "warmup_s": warm_s, "steady_s": dt,
        "active_blocks": slam.num_active, "capacity": slam.capacity, "pool_growths": grew,
        "block_overflow": slam.overflow, "key_saturated_frames": slam.key_saturated_frames,
        "max_rmse": float(np.max(rmses)),
    }
    print("fused:", fused, flush=True)
    if slam.overflow != 0:
        raise AssertionError(f"the fused pool overflowed despite growth: {slam.overflow} blocks")

    # ---- 2. the device-resident sparse FBA with loop closure ----
    def run_sparse(record: bool):
        fba = FusedFBASlam(cam, device=dev)
        for s in range(0, n, ck):
            info = fba.process_chunk(grays[s : s + ck], depths[s : s + ck])
            if record:
                metrics.append({"system": "fba", "frame": min(s + ck, n), "keyframes": fba.num_kf,
                                "edges": fba.num_edges, "lc_pairs": info["lc_pairs"]})
        sync()
        return fba

    t0 = time.perf_counter()
    run_sparse(record=False)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fba = run_sparse(record=True)
    dt = time.perf_counter() - t0
    fba_ate = float(traj.ate_rmse(fba.trajectory(), poses))
    sparse = {
        "fps": n / dt, "ate_rmse_m": fba_ate, "warmup_s": warm_s, "steady_s": dt, "keyframes": fba.num_kf,
        "edges": fba.num_edges, "loop_edges": fba.lc_edges_total, "edge_overflow": fba.edge_overflow,
    }
    print("fba:", sparse, flush=True)
    if fba.edge_overflow != 0:
        raise AssertionError(f"the FBA edge store overflowed despite growth: {fba.edge_overflow}")
    if args.scale == 1 and not fba_ate <= MAX_FBA_ATE_M:
        raise AssertionError(f"long-run sparse drift: ATE {fba_ate} m > {MAX_FBA_ATE_M} m")
    if args.scale != 1:
        print(f"FBA ATE {fba_ate} m at {cam.width}x{cam.height}: the {MAX_FBA_ATE_M} m bar is the 640x480 loop's, "
              "not applied")

    with open(args.metrics, "w") as f:
        f.writelines(json.dumps(m) + "\n" for m in metrics)
    summary = {"frames": n, "camera": f"{cam.width}x{cam.height}", "device": str(dev), "fused": fused,
               "sparse_fba": sparse}
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out} + {args.metrics}")
    return summary


if __name__ == "__main__":
    main()
