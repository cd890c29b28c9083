#!/usr/bin/env python3
"""Sweep the dense tracker's formulation knobs against the ATE (the port's
`tools/ate_sweep.py`).

    python3 tools/torch_ate_sweep.py                          # 16 frames of the 640x480 orbit, on the card
    python3 tools/torch_ate_sweep.py --scale 8 --frames 4 --device cpu

Renders the first `--frames` frames of the 16-frame synthetic orbit, then for each run A-I preprocesses every frame
(`odometry/dense.preprocess_frame` with or without the depth blur and the
per-frame intensity normalisation) and chains frame-to-frame
`dense_tracking` (on the card, the GN-step kernel; the depth gate
`depth_diff_max` 0.07 or the reference's 0.05, with or without the
reference's pair intensity normalisation), each pair started from the
previous pair's motion. Prints each run's ATE and mean relative rotation
error. The knobs are the ones where the reference (DenseOdometryFunction.cpp)
and an earlier exact path differed: MAX_DIFF_DEPTH 0.05 against 0.07, the
Gaussian-blurred depth, NormalizeIntensity to mean 0.5. Run G repeats C: its
masked depth Sobel is the tracker's own form now, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_common import add_device_arg, scaled_camera  # noqa: E402
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA  # noqa: E402
from onepiece_tpu_torch.io import trajectory as traj  # noqa: E402
from onepiece_tpu_torch.odometry import dense  # noqa: E402
from onepiece_tpu_torch.utils import synthetic  # noqa: E402

ORBIT_FRAMES = 16  # tools/ate_sweep.py's sequence
NO_BLUR = dict(depth_blur=False, intensity_norm=False)
BLUR = dict(depth_blur=True, intensity_norm=False)
# (name, preprocess options, tracking options), as tools/ate_sweep.py runs them
RUNS = (
    ("A baseline (r02 exact)", NO_BLUR, dict(depth_diff_max=0.07)),
    ("B ddm=0.05", NO_BLUR, dict(depth_diff_max=0.05)),
    ("C B + depth blur", BLUR, dict(depth_diff_max=0.05)),
    ("D C + intensity norm", dict(depth_blur=True, intensity_norm=True), dict(depth_diff_max=0.05)),
    ("E norm only", dict(depth_blur=False, intensity_norm=True), dict(depth_diff_max=0.05)),
    ("F blur only ddm 0.07", BLUR, dict(depth_diff_max=0.07)),
    ("G C + masked zSobel", BLUR, dict(depth_diff_max=0.05)),
    ("H G + pair norm", BLUR, dict(depth_diff_max=0.05, pair_norm=True)),
    ("I H w/o depth blur", NO_BLUR, dict(depth_diff_max=0.05, pair_norm=True)),
)


def sweep(cam, grays, depths, poses, runs=RUNS) -> dict:
    """{run name: (ATE m, mean relative rotation error deg, seconds)} over the
    frames (grays, depths (N, H, W) on the run's device) with ground truth
    `poses` (N, 4, 4)."""
    out = {}
    n = len(poses)
    for name, pre_kw, track_kw in runs:
        pyrs = [dense.preprocess_frame(g, d, cam, **pre_kw) for g, d in zip(grays, depths)]
        t0 = time.perf_counter()
        est = [np.eye(4, dtype=np.float32)]
        rel_r = []
        T_rel = torch.eye(4, device=grays.device)
        for i in range(1, n):
            T_rel = dense.dense_tracking(pyrs[i - 1], pyrs[i], cam, init_T=T_rel, **track_kw).T_ts
            Tn = T_rel.cpu().numpy()
            est.append(est[-1] @ np.linalg.inv(Tn))
            dd = np.linalg.inv(np.linalg.inv(poses[i]) @ poses[i - 1]) @ Tn
            rel_r.append(np.rad2deg(np.arccos(np.clip((np.trace(dd[:3, :3]) - 1) / 2, -1, 1))))
        ate = traj.ate_rmse(np.stack(est), poses)
        out[name] = (ate, float(np.mean(rel_r)), time.perf_counter() - t0)
        print(f"{name:36s} ate={ate * 1000:7.2f} mm  rel_r mean={np.mean(rel_r):6.4f} deg  "
              f"({out[name][2]:.2f}s)", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=ORBIT_FRAMES, help="the first N frames of the orbit")
    ap.add_argument("--scale", type=int, default=1, help="downscale factor of camera and render (power of 2)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    cam = scaled_camera(TUM_CAMERA, args.scale)
    poses = synthetic.orbit_trajectory(ORBIT_FRAMES)[: args.frames]
    scene = synthetic.default_scene(args.device)
    frames = [synthetic.render(scene, torch.from_numpy(p).to(args.device), cam.fx, cam.fy, cam.cx, cam.cy,
                               cam.height, cam.width, num_steps=64) for p in poses]
    return sweep(cam, torch.stack([g for _, g in frames]), torch.stack([d for d, _ in frames]), poses)


if __name__ == "__main__":
    main()
