#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`onepiece_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final `ok` line:
  1. require CUDA; print the card's name and power limit
  2. build the CUDA kernels of onepiece_tpu_torch/csrc/ with nvcc (sm_90a)
  3. TSDF-integrate kernel vs its plain PyTorch version on a real 640x480
     frame (K = 8192 touched slots, a 16385-row pool)
  4. dense normal-equations kernel vs its plain version at 640x480,
     320x240 and 160x120
  5. the slice: FusedDenseFusion on the 16-frame 640x480 orbit
     (process_chunk -> finalize -> to_volume); ATE, block overflow, the
     kernels' launch counts and the absence of host syncs in the frame loop
     are checked, and ms per frame is timed over 5 fresh runs after one
     warm run
Prints one JSON line of per-kernel results, the card line, then
{"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 16
RENDER_STEPS = 64
KERNEL1_TOL = 1e-5  # sdf and colour, absolute; weights must be equal
KERNEL2_TOL = 1e-4  # JTJ, JTr, cost: max |kernel - plain| / max |plain|
MAX_ATE_M = 2.0e-3
TIMED_RUNS = 5


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def main() -> int:
    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.geometry import se3
    from onepiece_tpu_torch.geometry.camera import TUM_CAMERA as cam
    from onepiece_tpu_torch.integration import device_hash as dh
    from onepiece_tpu_torch.io import trajectory as traj
    from onepiece_tpu_torch.odometry import dense
    from onepiece_tpu_torch.ops import dense_odometry as dops
    from onepiece_tpu_torch.ops import tsdf as tsdf_ops
    from onepiece_tpu_torch.ops import tsdf_slots
    from onepiece_tpu_torch.ops.image import bilateral_filter
    from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
    from onepiece_tpu_torch.utils import synthetic

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.library()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    poses = synthetic.orbit_trajectory(N_FRAMES)
    scene = synthetic.default_scene(dev)
    frames = [
        synthetic.render(
            scene, torch.from_numpy(p).to(dev), cam.fx, cam.fy, cam.cx, cam.cy,
            cam.height, cam.width, num_steps=RENDER_STEPS,
        )
        for p in poses
    ]
    depths = torch.stack([d for d, _ in frames])
    grays = torch.stack([g for _, g in frames])
    results = {}

    # ---- 3. TSDF integrate vs plain ---------------------------------------
    slam = FusedDenseFusion(cam, device=dev)
    vsz, trunc, kmax = slam.voxel_size, slam.truncation, slam.kmax
    intr = (cam.fx, cam.fy, cam.cx, cam.cy)
    pool = tsdf_slots.make_pool(slam.capacity, dev)
    table = dh.make_table(slam.table_size, slam.capacity, dev)
    T_w = [torch.eye(4, device=dev), torch.from_numpy(np.linalg.inv(poses[0]) @ poses[1]).to(dev)]
    for i in range(2):  # fuse frame 0 (plain), then integrate frame 1 both ways
        d_f = bilateral_filter(depths[i])
        keys = tsdf_ops.touched_block_keys(d_f, T_w[i], *intr, vsz, trunc, max_blocks=kmax, stride=slam.stride)
        table, slots = dh.insert(table, keys, claim_rounds=12 if i == 0 else 2)
        slots = torch.where(slots < 0, slam.capacity, slots).to(torch.int32)
        args = (keys, slots, torch.stack([d_f, grays[i]]), se3.inverse_T(T_w[i]), *intr, vsz, trunc)
        if i == 0:
            tsdf_slots.integrate_slots_reference(pool, *args)
    n_keys = int((keys != tsdf_ops.INVALID_KEY).sum())
    vk = tsdf_slots.integrate_slots(pool.clone(), *args)
    vp = tsdf_slots.integrate_slots_reference(pool.clone(), *args)
    torch.cuda.synchronize()
    body = slice(0, slam.capacity)  # the trash row holds garbage by design
    if not torch.equal(vk[body, 1], vp[body, 1]):
        raise AssertionError("tsdf_integrate: weights differ from the plain version")
    err1 = float((vk[body] - vp[body]).abs().max())
    if not err1 <= KERNEL1_TOL:
        raise AssertionError(f"tsdf_integrate: max |sdf/colour err| {err1} > {KERNEL1_TOL}")
    scratch = pool.clone()
    ms1 = cuda_ms(lambda: tsdf_slots.integrate_slots(scratch, *args))
    plain_ms1 = cuda_ms(lambda: tsdf_slots.integrate_slots_reference(scratch, *args))
    results["tsdf_integrate"] = dict(max_abs_err=err1, ms=ms1, plain_ms=plain_ms1)
    print(f"tsdf_integrate: K={kmax} ({n_keys} real keys), pool {tuple(pool.shape)}: "
          f"max abs err {err1:.3g}, weights equal; kernel {ms1:.4f} ms, plain {plain_ms1:.4f} ms",
          flush=True)
    del pool, vk, vp, scratch

    # ---- 4. dense normal equations vs plain -------------------------------
    src = dense.preprocess_frame(grays[0], depths[0], cam)
    tgt = dense.preprocess_frame(grays[1], depths[1], cam)
    eye = torch.eye(4, device=dev)  # the first iteration's pose (rel = I)
    err2 = 0.0
    for li, c in enumerate(cam.pyramid(3)):
        term = dops.build_term_data(tgt.grays[li], tgt.depths[li], dense.SOBEL_SCALE)
        pts = src.xyzs[li].reshape(-1, 3)
        args = (eye, pts, src.grays[li].reshape(-1), pts[:, 2] > 0, term, c.fx, c.fy, c.cx, c.cy,
                dense.LAMBDA_HYBRID_DEPTH, dense.DEPTH_DIFF_MAX)
        nk = dops.normal_equations(*args)
        npl = dops.normal_equations_reference(*args)
        rel = [rel_err(a, b) for a, b in zip(nk[:3], npl[:3])]
        if not max(rel) <= KERNEL2_TOL:
            raise AssertionError(f"dense_normal_eq level {li}: rel err {rel} > {KERNEL2_TOL}")
        if float(nk.num_inliers) != float(npl.num_inliers):
            raise AssertionError(
                f"dense_normal_eq level {li}: inliers {float(nk.num_inliers)} != {float(npl.num_inliers)}")
        ms = cuda_ms(lambda: dops.normal_equations(*args))
        plain_ms = cuda_ms(lambda: dops.normal_equations_reference(*args))
        abs_err = max(float((a - b).abs().max()) for a, b in zip(nk[:3], npl[:3]))
        print(f"dense_normal_eq {c.width}x{c.height}: rel err JTJ {rel[0]:.3g} JTr {rel[1]:.3g} "
              f"cost {rel[2]:.3g}, inliers {int(nk.num_inliers)} equal; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        err2 = max(err2, abs_err)
        if li == 0:
            results["dense_normal_eq"] = dict(ms=ms, plain_ms=plain_ms)
    results["dense_normal_eq"]["max_abs_err"] = err2

    # ---- 5. the slice -----------------------------------------------------
    def run(forbid_syncs: bool = False) -> tuple[FusedDenseFusion, np.ndarray, float]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = FusedDenseFusion(cam, device=dev)
        # the frame loop must never wait for the device: any synchronizing
        # operation inside it raises in this mode
        torch.cuda.set_sync_debug_mode("error" if forbid_syncs else "default")
        try:
            s.process_chunk(grays, depths)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        est, _ = s.finalize()
        torch.cuda.synchronize()
        return s, est, (time.perf_counter() - t) * 1e3 / N_FRAMES

    run()  # warm: allocator, kernel library, cuBLAS/cuSOLVER handles
    _build.reset_launch_counts()
    slam, est, _ = run(forbid_syncs=True)
    launches = {k.name: k.launches for k in _build.KERNELS}
    expect = {"tsdf_integrate": N_FRAMES, "dense_normal_eq": sum(slam.iters) * (N_FRAMES - 1)}
    if launches != expect:
        raise AssertionError(f"kernel launches on the main path {launches}, expected {expect}")
    ate = traj.ate_rmse(est, poses)
    vol = slam.to_volume()
    active = vol.weight[: vol.num_active] > 0
    if not (np.isfinite(est).all() and ate <= MAX_ATE_M):
        raise AssertionError(f"ATE {ate} m > {MAX_ATE_M} m (or non-finite poses)")
    if slam.overflow != 0:
        raise AssertionError(f"block overflow {slam.overflow}")
    if not (vol.num_active == len(vol.slot_of) > 0 and bool(active.any())
            and bool(torch.isfinite(vol.sdf[: vol.num_active][active]).all())):
        raise AssertionError("to_volume: empty or non-finite volume")
    times = [run()[2] for _ in range(TIMED_RUNS)]
    print(f"slice 640x480 x {N_FRAMES} frames: ATE {ate * 1e3:.4f} mm, num_active {slam.num_active}, "
          f"overflow {slam.overflow}, key_saturated_frames {slam.key_saturated_frames}, "
          f"launches {launches}, host syncs in the frame loop 0", flush=True)
    print(f"slice ms/frame over {TIMED_RUNS} fresh runs: median {np.median(times):.3f}, "
          f"p95 {np.percentile(times, 95):.3f} (runs {[round(t, 3) for t in times]}) on {card}",
          flush=True)

    kernels = [
        dict(name=k.name, route="cuda", source=k.source, replaces=k.replaces,
             launches=launches[k.name], **results[k.name])
        for k in _build.KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
