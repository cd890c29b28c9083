#!/usr/bin/env python3
"""How far the JAX package's production tracker is from the exact one, and
the PyTorch port's fusion loop from the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_tracker_gap.py [--steps 64 48]

On the first 4 frames of the 16-frame orbit at 80x60 (kmax=512, stride=2,
as `tests/test_torch_fused_slam.py` runs them), for each sphere-tracing
step count it prints, per frame pair, the largest translation difference
in mm between:

  - JAX `dense_tracking` (bf16 prewarp + stencil) and JAX
    `dense_tracking_exact`, on the same pyramids from the identity;
  - the relative poses of the port's `FusedDenseFusion` (exact gather
    form) and of the JAX package's (prewarp form, Pallas TSDF kernel in
    interpret mode);

and both loops' ATE against the ground truth. The last line of standard
output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.io import trajectory as jtraj
from onepiece_tpu.odometry import dense as jdense
from onepiece_tpu.systems import fused_slam as jfs
from onepiece_tpu.utils import synthetic as jsyn
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA as TCAM
from onepiece_tpu_torch.systems import fused_slam as tfs

N = 4
KW = dict(capacity=2048, table_size=1 << 12, kmax=512, stride=2)


def _rel(T):
    return [np.linalg.inv(T[i - 1]) @ T[i] for i in range(1, len(T))]


def _trans_mm(a, b) -> float:
    return float(np.abs(a[:3, 3] - b[:3, 3]).max() * 1e3)


def gap(steps: int) -> dict:
    cam_j, cam_t = JCAM.pyramid(4)[3], TCAM.pyramid(4)[3]
    poses = jsyn.orbit_trajectory(16)[:N]
    scene = jsyn.default_scene()
    frames = [
        jsyn.render(scene, jnp.asarray(p), cam_j.fx, cam_j.fy, cam_j.cx, cam_j.cy,
                    cam_j.height, cam_j.width, num_steps=steps)
        for p in poses
    ]
    grays = np.stack([np.array(g) for _, g in frames])
    depths = np.stack([np.array(d) for d, _ in frames])

    pyr = [jdense.preprocess_frame(jnp.asarray(g), jnp.asarray(d), cam_j) for g, d in zip(grays, depths)]
    trackers = [
        _trans_mm(np.asarray(jdense.dense_tracking(pyr[i - 1], pyr[i], cam_j, init_T=jnp.eye(4)).T_ts),
                  np.asarray(jdense.dense_tracking_exact(pyr[i - 1], pyr[i], cam_j, init_T=jnp.eye(4)).T_ts))
        for i in range(1, N)
    ]

    slam_j = jfs.FusedDenseFusion(cam_j, interpret=True, **KW)
    for g, d in zip(grays, depths):
        slam_j.process_frame(g, d)
    est_j, _ = slam_j.finalize()
    slam_t = tfs.FusedDenseFusion(cam_t, device="cpu", **KW)
    slam_t.process_chunk(grays, depths)
    est_t, _ = slam_t.finalize()
    return {
        "steps": steps,
        "jax_prewarp_vs_exact_mm": trackers,
        "port_loop_vs_jax_loop_mm": [_trans_mm(a, b) for a, b in zip(_rel(est_t), _rel(est_j))],
        "ate_port_mm": jtraj.ate_rmse(est_t, poses) * 1e3,
        "ate_jax_mm": jtraj.ate_rmse(est_j, poses) * 1e3,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, nargs="+", default=[64, 48])
    args = ap.parse_args(argv)
    out = [gap(s) for s in args.steps]
    for r in out:
        print(f"{r['steps']} steps: JAX prewarp vs exact per pair (mm) "
              f"{[round(x, 3) for x in r['jax_prewarp_vs_exact_mm']]}; port loop vs JAX loop (mm) "
              f"{[round(x, 3) for x in r['port_loop_vs_jax_loop_mm']]}; "
              f"ATE port {r['ate_port_mm']:.3f} mm, JAX {r['ate_jax_mm']:.3f} mm")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
