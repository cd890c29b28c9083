#!/usr/bin/env python3
"""The sparse orbit's ATE in both packages over the same frames, at several
RANSAC seeds (ROADMAP queue 3: the port's FusedFBASlam against the JAX
package's).

    JAX_PLATFORMS=cpu python3 tools/torch_sparse_ate_gap.py [--seeds 0 1 2 3 4] [--level 0]

Renders the 16-frame synthetic orbit once (the port's renderer, 640x480 at
`--level 0`), then runs `FusedFBASlam` with its defaults (1,000 keypoints,
one chunk, as `chip_smoke.py` phase 9's orbit cell) in the JAX package and
in the port, both on the CPU, for each seed: the seed replaces each
system's draw generator (`_rng`, which seeds the RANSAC hypotheses), so a
seed gives each package other draws, not the same ones. The JAX package
picks its keypoints with the exact `lax.top_k` in place of `approx_max_k`
(~0.95 recall), the port's selection. Prints each run's ATE, keyframes and
edges, then the two spreads (min, median, max) and whether the port's
covers the JAX package's; one JSON line last. Needs JAX, so it runs on the
CPU only, not on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--level", type=int, default=0, help="camera pyramid level (0: 640x480)")
    args = ap.parse_args(argv)

    import jax

    from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
    from onepiece_tpu.systems.fused_sparse import FusedFBASlam as JaxFBA
    from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
    from onepiece_tpu_torch.io import trajectory as traj
    from onepiece_tpu_torch.systems.fused_sparse import FusedFBASlam
    from onepiece_tpu_torch.utils import synthetic

    jax.lax.approx_max_k = lambda operand, k, **_: jax.lax.top_k(operand, k)  # the exact top-k
    cam, jcam = TUM_CAMERA.pyramid(args.level + 1)[args.level], JCAM.pyramid(args.level + 1)[args.level]
    poses = synthetic.orbit_trajectory(args.frames)
    scene = synthetic.default_scene()
    t = time.perf_counter()
    frames = [synthetic.render(scene, torch.from_numpy(p), cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width,
                               num_steps=64) for p in poses]
    grays = np.stack([g.numpy() for _, g in frames])
    depths = np.stack([d.numpy() for d, _ in frames])
    print(f"rendered {args.frames} frames at {cam.width}x{cam.height} in {time.perf_counter() - t:.1f} s", flush=True)

    runs = {"jax": [], "port": []}
    for seed in args.seeds:
        for name in ("jax", "port"):
            slam = JaxFBA(jcam) if name == "jax" else FusedFBASlam(cam, device="cpu")
            slam._rng = np.random.default_rng(seed)
            t = time.perf_counter()
            slam.process_chunk(grays if name == "jax" else torch.from_numpy(grays),
                               depths if name == "jax" else torch.from_numpy(depths))
            ate = float(traj.ate_rmse(slam.trajectory(), poses))
            runs[name].append(dict(seed=seed, ate_m=ate, keyframes=slam.num_kf, edges=slam.num_edges))
            print(f"seed {seed} {name}: ATE {ate * 1e3:.4f} mm, {slam.num_kf} keyframes, {slam.num_edges} edges "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
    spread = {k: [float(f(np.array([r["ate_m"] for r in v]))) for f in (np.min, np.median, np.max)]
              for k, v in runs.items()}
    covers = spread["port"][0] <= spread["jax"][0] and spread["port"][2] >= spread["jax"][2]
    for k, (lo, mid, hi) in spread.items():
        print(f"{k}: ATE min {lo * 1e3:.4f}, median {mid * 1e3:.4f}, max {hi * 1e3:.4f} mm over seeds {args.seeds}")
    print(f"the port's spread covers the JAX package's: {covers}")
    out = dict(camera=f"{cam.width}x{cam.height}", frames=args.frames, runs=runs, spread_m=spread,
               port_covers_jax=covers)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
