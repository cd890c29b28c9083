#!/usr/bin/env python3
"""Where the time of the PyTorch port's dense fusion loop goes.

    python3 tools/profile_torch_slice.py                 # 640x480, 16 frames, cuda
    python3 tools/profile_torch_slice.py --level 3 --frames 3 --device cpu

Renders the orbit at `TUM_CAMERA.pyramid(level + 1)[level]` (level 0 is
640x480), runs one warm `FusedDenseFusion` pass, then measures:

  1. stages: each stage of the frame step (as `systems/fused_slam.py:
     _frame_body` runs them) timed alone on the host clock and ended by a
     device sync; mean ms over frames 1..N-1;
  2. one Gauss-Newton iteration at the finest level: `gauss_newton` with
     iters=1 (on the card one kernel launch that linearises, solves and
     updates the pose) and `normal_equations` (the linearisation alone),
     each timed alone (host clock, synced) over 20 calls;
  3. host syncs in `process_chunk` (CUDA only): synchronizing operations
     counted with `torch.cuda.set_sync_debug_mode("warn")`, by the line
     that made them;
  4. one profiled `process_chunk` + `finalize` (`torch.profiler`): device
     operations per frame, device busy time (union of the device events)
     and its share of the profiled wall time, and the host's time in kernel
     launch calls.

A number the run could not measure (e.g. device time on a CPU run) is
printed as null. The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from onepiece_tpu_torch import _build
from onepiece_tpu_torch.geometry import se3
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.integration import device_hash as dh
from onepiece_tpu_torch.odometry import dense
from onepiece_tpu_torch.ops import dense_odometry as dops
from onepiece_tpu_torch.ops import tsdf as tsdf_ops
from onepiece_tpu_torch.ops import tsdf_slots
from onepiece_tpu_torch.ops.image import bilateral_filter
from onepiece_tpu_torch.systems import fused_slam
from onepiece_tpu_torch.utils import synthetic


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    """(result, host ms) of fn(), from a drained queue to a drained queue."""
    _sync(dev)
    t = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t) * 1e3


def stage_times(slam: fused_slam.FusedDenseFusion, grays, depths) -> dict[str, float]:
    """Mean host ms per frame of each stage of the frame step, frames 1..N-1."""
    dev, cam = slam.device, slam.camera
    intr = (cam.fx, cam.fy, cam.cx, cam.cy)
    slam.process_frame(grays[0], depths[0])
    st = slam._state
    vox, table, prev, T_w, rel = st.vox, st.table, st.pyr, st.T_w, st.rel
    acc: dict[str, list[float]] = {}

    def stage(name, fn):
        out, ms = _timed(dev, fn)
        acc.setdefault(name, []).append(ms)
        return out

    for g, d in zip(grays[1:], depths[1:]):
        pyr = stage("preprocess_frame", lambda: dense.preprocess_frame(g, d, cam))
        res = stage("dense_tracking", lambda: dense.dense_tracking(prev, pyr, cam, init_T=rel, iters=slam.iters))
        T_w, depth_f = stage(
            "pose chain + bilateral_filter",
            lambda: (dense.chain_pose(T_w, res.T_ts), bilateral_filter(d)),
        )
        keys = stage("touched_block_keys", lambda: tsdf_ops.touched_block_keys(
            depth_f, T_w, *intr, slam.voxel_size, slam.truncation, max_blocks=slam.kmax, stride=slam.stride))
        table, slots = stage("hash insert", lambda: dh.insert(
            table, keys, claim_rounds=fused_slam.FRAME_CLAIM_ROUNDS))

        def integrate():
            s = torch.where(slots < 0, vox.shape[0] - 1, slots).to(torch.int32)
            return tsdf_slots.integrate_slots(
                vox, keys, s, torch.stack([depth_f, g]), se3.inverse_T(T_w), *intr,
                slam.voxel_size, slam.truncation, fused_slam.MAX_WEIGHT)

        stage("integrate_slots", integrate)
        prev, rel = pyr, res.T_ts
    return {k: float(np.mean(v)) for k, v in acc.items()}


def gn_iteration_times(slam, grays, depths, reps: int = 20) -> dict[str, float]:
    """Host ms of one Gauss-Newton step and of one linearisation alone at the
    finest level, mean over `reps` synced calls."""
    dev, cam = slam.device, slam.camera
    src = dense.preprocess_frame(grays[0], depths[0], cam)
    tgt = dense.preprocess_frame(grays[1], depths[1], cam)
    term = dops.build_term_data(tgt.grays[0], tgt.depths[0], dense.SOBEL_SCALE)
    pts = src.xyzs[0].reshape(-1, 3)
    gray = src.grays[0].reshape(-1)
    rest = (cam.fx, cam.fy, cam.cx, cam.cy, dense.LAMBDA_HYBRID_DEPTH, dense.DEPTH_DIFF_MAX)
    T = torch.eye(4, device=dev)

    def step():
        return dops.gauss_newton(T, pts, gray, term, *rest, iters=1)

    def linearise():
        return dops.normal_equations(T, pts, gray, pts[:, 2] > 0, term, *rest)

    step()
    linearise()
    step_ms = [_timed(dev, step)[1] for _ in range(reps)]
    ne_ms = [_timed(dev, linearise)[1] for _ in range(reps)]
    return {"gauss_newton_step": float(np.mean(step_ms)), "normal_equations": float(np.mean(ne_ms))}


def count_syncs(dev: torch.device, work) -> dict[str, int] | None:
    """Synchronizing operations in work(), by the Python line that made
    them (None off CUDA)."""
    if dev.type != "cuda":
        return None
    _sync(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            work()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites: dict[str, int] = {}
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            site = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def _union_us(ranges: list[tuple[float, float]]) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(ranges):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_run(make, grays, depths) -> dict:
    """Device operations, busy time and launch-call time of one profiled run."""
    from torch.profiler import ProfilerActivity, profile

    dev = make().device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        slam = make()
        slam.process_chunk(grays, depths)
        slam.finalize()
        _sync(dev)
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.events()
    on_dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    launch_us = sum(e.time_range.elapsed_us() for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU and "LaunchKernel" in e.name)
    n = len(grays)
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in on_dev]) / 1e3 if on_dev else None
    return {
        "wall_ms": wall_ms,
        "device_ops": len(on_dev) if on_dev else None,
        "device_ops_per_frame": len(on_dev) / n if on_dev else None,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if on_dev else None,
        "launch_call_share": launch_us / 1e3 / wall_ms if dev.type == "cuda" else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--level", type=int, default=0, help="TUM_CAMERA pyramid level (0 = 640x480)")
    ap.add_argument("--render-steps", type=int, default=64)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("profile_torch_slice: torch.cuda.is_available() is False", file=sys.stderr)
            return 1
        _build.library()
    cam = TUM_CAMERA.pyramid(args.level + 1)[args.level]
    scene = synthetic.default_scene(dev)
    frames = [
        synthetic.render(scene, torch.from_numpy(p).to(dev), cam.fx, cam.fy, cam.cx, cam.cy,
                         cam.height, cam.width, num_steps=args.render_steps)
        for p in synthetic.orbit_trajectory(args.frames)
    ]
    depths = torch.stack([d for d, _ in frames])
    grays = torch.stack([g for _, g in frames])

    def make():
        return fused_slam.FusedDenseFusion(cam, device=dev)

    warm = make()  # allocator, kernel library, solver handles
    warm.process_chunk(grays, depths)
    warm.finalize()
    slam = make()

    out = {
        "size": f"{cam.width}x{cam.height}",
        "frames": args.frames,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "stage_ms_per_frame": stage_times(make(), grays, depths),
        "gn_iteration_ms": gn_iteration_times(make(), grays, depths),
        "host_sync_sites_in_process_chunk": count_syncs(dev, lambda: slam.process_chunk(grays, depths)),
        "profile": profile_run(make, grays, depths),
    }
    stages = out["stage_ms_per_frame"]
    total = sum(stages.values())
    for name, ms in stages.items():
        print(f"{name:32s} {ms:9.4f} ms/frame  {100 * ms / total:5.1f} %")
    for name, ms in out["gn_iteration_ms"].items():
        print(f"per GN iteration: {name:18s} {ms:9.4f} ms")
    print(f"host syncs in process_chunk, by site: {out['host_sync_sites_in_process_chunk']}")
    print(f"profile: {out['profile']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
