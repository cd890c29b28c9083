#!/usr/bin/env python3
"""The host-loop systems' accuracy in both packages on `chip_smoke.py` phase
13's sequences, at several seeds (the regime that phase 13 holds the port to).

    JAX_PLATFORMS=cpu python3 tools/host_loop_ate_gap.py [--seeds 0 1 2] [--level 0] [--packages jax port]
    python3 tools/host_loop_ate_gap.py --packages port --device cuda --seeds 0 1 2 3 4 5 6 7 8 9

Renders the 16-frame synthetic orbit and the 100-frame closed loop once
(the port's renderer on `--device`, 640x480 at `--level 0`), then runs, with
TUM_CAMERA defaults, `FBASlam` and `BASlam` frame by frame (`update_frame`)
on the orbit and a chunk of 25 at a time (`process_chunk`) on the loop, in
the JAX package (on the CPU) and in the port (on `--device`), for each seed:
the seed replaces each system's draw generator (`_rng`), so a seed gives
each package other draws, not the same ones. Prints each run's ATE, RPE
(translation over consecutive frames and over RPE_SPAN frames, rotation over
RPE_SPAN frames), keyframes, lost frames and (port)
loop-closure edges or linked pairs, then per cell the packages' spreads
(min, median, max) beside a camera that never moves (the identity at every
frame); with `--pairs K,F`, each package's success rate over `--draws`
draws at the track of loop frame K to F; one JSON line last. The JAX
package is imported only with `--packages jax`, so `--packages port` runs
on the card's machine.
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

LOOP_CHUNK = 25  # chip_smoke.py's LOOP_CHUNK
RENDER_STEPS = 64  # chip_smoke.py's RENDER_STEPS
# frames: RPE over consecutive frames reads a tracker's white per-frame
# error as much as a still camera's missing motion; over 8 frames the
# motion dominates
RPE_SPAN = 8


def errors(est, gt, traj) -> dict:
    """ATE, RPE over consecutive frames and over RPE_SPAN frames (m), and
    the rotation's RPE over RPE_SPAN frames (degrees)."""
    t_span, r_span = traj.rpe_rmse(est, gt, delta=RPE_SPAN)
    return {"ate_m": traj.ate_rmse(est, gt), "rpe_m": traj.rpe_rmse(est, gt)[0], "rpe_span_m": t_span,
            "rpe_span_deg": float(np.degrees(r_span))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--orbit-frames", type=int, default=16)
    ap.add_argument("--loop-frames", type=int, default=100)
    ap.add_argument("--level", type=int, default=0, help="camera pyramid level (0: 640x480)")
    ap.add_argument("--cells", nargs="*", default=["FBASlam orbit", "FBASlam loop", "BASlam orbit", "BASlam loop"])
    ap.add_argument("--pairs", nargs="*", default=[], metavar="K,F",
                    help="loop frames K -> F: each package's track success rate over --draws draws")
    ap.add_argument("--draws", type=int, default=100)
    ap.add_argument("--packages", nargs="+", choices=("jax", "port"), default=["jax", "port"])
    ap.add_argument("--device", default="cpu", help="the port's device (and the renderer's)")
    args = ap.parse_args(argv)

    from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
    from onepiece_tpu_torch.io import trajectory as traj
    from onepiece_tpu_torch.systems.baslam import BASlam
    from onepiece_tpu_torch.systems.fbaslam import FBASlam
    from onepiece_tpu_torch.utils import synthetic

    dev = torch.device(args.device)
    cam = TUM_CAMERA.pyramid(args.level + 1)[args.level]
    classes = {"FBASlam": {"port": (FBASlam, cam, {"device": dev})},
               "BASlam": {"port": (BASlam, cam, {"device": dev})}}
    if "jax" in args.packages:
        import jax
        import jax.numpy as jnp

        from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
        from onepiece_tpu.odometry import sparse as jsparse
        from onepiece_tpu.systems.baslam import BASlam as JaxBA
        from onepiece_tpu.systems.fbaslam import FBASlam as JaxFBA

        jcam = JCAM.pyramid(args.level + 1)[args.level]
        classes["FBASlam"]["jax"] = (JaxFBA, jcam, {})
        classes["BASlam"]["jax"] = (JaxBA, jcam, {})
    scene = synthetic.default_scene(dev)

    def render(poses):
        out = [synthetic.render(scene, torch.from_numpy(p).to(dev), cam.fx, cam.fy, cam.cx, cam.cy, cam.height,
                                cam.width, num_steps=RENDER_STEPS) for p in poses]
        return np.stack([g.cpu().numpy() for _, g in out]), np.stack([d.cpu().numpy() for d, _ in out]), poses

    t = time.perf_counter()
    trajs = {"orbit": lambda: synthetic.orbit_trajectory(args.orbit_frames),
             "loop": lambda: synthetic.loop_trajectory(args.loop_frames)}
    seqs = {seq: render(make()) for seq, make in trajs.items()
            if any(c.endswith(seq) for c in args.cells) or (seq == "loop" and args.pairs)}
    print(f"rendered in {time.perf_counter() - t:.1f} s", flush=True)
    frozen = {}
    for seq, (_, _, poses) in seqs.items():
        still = np.tile(np.eye(4), (len(poses), 1, 1))
        frozen[seq] = errors(still, poses, traj)
        print(f"{seq}: a camera that never moves scores ATE {frozen[seq]['ate_m'] * 1e3:.3f} mm, RPE "
              f"{frozen[seq]['rpe_m'] * 1e3:.3f} mm, RPE over {RPE_SPAN} frames "
              f"{frozen[seq]['rpe_span_m'] * 1e3:.3f} mm and {frozen[seq]['rpe_span_deg']:.3f} deg", flush=True)
    runs = {}
    for cell in args.cells:
        system, seq = cell.split()
        grays, depths, poses = seqs[seq]
        for pkg in args.packages:
            cls, c, kw = classes[system][pkg]
            for seed in args.seeds:
                s = cls(c, **kw)
                s._rng = np.random.default_rng(seed)
                t = time.perf_counter()
                if seq == "orbit":
                    for g, d in zip(grays, depths):
                        s.update_frame(g, d)
                else:
                    for i in range(0, len(grays), LOOP_CHUNK):
                        s.process_chunk(grays[i : i + LOOP_CHUNK], depths[i : i + LOOP_CHUNK])
                est = s.trajectory()
                r = {**errors(est, poses, traj), "keyframes": len(s.keyframe_frames),
                     "lost": s.state.tracking_success.count(False), "lc": getattr(s, "lc_edges", None)}
                runs.setdefault(cell, {}).setdefault(pkg, []).append(r)
                print(f"{cell} {pkg} seed {seed}: ATE {r['ate_m'] * 1e3:.3f} mm, RPE {r['rpe_m'] * 1e3:.3f} mm, "
                      f"over {RPE_SPAN} frames {r['rpe_span_m'] * 1e3:.3f} mm and {r['rpe_span_deg']:.3f} deg, "
                      f"{r['keyframes']} keyframes, {r['lost']} frames lost, LC {r['lc']} "
                      f"({time.perf_counter() - t:.1f} s)", flush=True)
    rates = {}
    for pair in args.pairs:  # one keyframe-to-frame track of the loop, drawn again and again
        k, f = (int(x) for x in pair.split(","))
        grays, depths = seqs["loop"][0][[k, f]], seqs["loop"][1][[k, f]]
        kw = dict(max_keypoints=1000, threshold=0.01)  # the systems' defaults
        summ = {}  # package -> (success, inliers) per draw
        if "port" in args.packages:
            from onepiece_tpu_torch.odometry import sparse

            fr = sparse.extract_sparse_frames_batch(torch.from_numpy(grays).to(dev), torch.from_numpy(depths).to(dev),
                                                    cam, **kw)
            a, b = (sparse.map_frame(lambda t: t[i], fr) for i in (0, 1))
            gen = [torch.Generator(device=dev).manual_seed(1000 + r) for r in range(args.draws)]
            summ["port"] = [sparse._track_summary_inner(g, a, b, cam)[1] for g in gen]
        if "jax" in args.packages:
            fr = jsparse.extract_sparse_frames_batch(jnp.asarray(grays), jnp.asarray(depths), jcam, **kw)
            a, b = (jax.tree.map(lambda t: t[i], fr) for i in (0, 1))
            summ["jax"] = [jsparse._track_summary_inner(jax.random.PRNGKey(1000 + r), a, b, jcam)[1]
                           for r in range(args.draws)]
        rates[pair] = {pkg: float(np.mean([bool(x.success) for x in v])) for pkg, v in summ.items()}
        print(f"loop frames {k} -> {f} over {args.draws} draws: " + "; ".join(
            f"{pkg} tracks {rates[pair][pkg]:.3f} (inliers median {np.median([int(x.num_inliers) for x in v]):g}, "
            f"lowest {sorted(int(x.num_inliers) for x in v)[:4]})" for pkg, v in summ.items()), flush=True)
    for cell, by in runs.items():
        seq = cell.split()[1]
        for key in ("ate_m", "rpe_m", "rpe_span_m", "rpe_span_deg"):
            name, unit = key.rsplit("_", 1)
            scale = 1e3 if unit == "m" else 1.0
            unit = "mm" if unit == "m" else unit
            print(f"{cell} {name}: " + "; ".join(
                f"{pkg} min {min(x[key] for x in v) * scale:.3f} median {np.median([x[key] for x in v]) * scale:.3f} "
                f"max {max(x[key] for x in v) * scale:.3f} {unit}" for pkg, v in by.items())
                + f"; never moving {frozen[seq][key] * scale:.3f} {unit}", flush=True)
    summary = {cell: {pkg: {key: [x[key] for x in v] for key in v[0]} for pkg, v in by.items()}
               for cell, by in runs.items()}
    print(json.dumps({"runs": summary, "frozen": frozen, "pair_track_rates": rates, "seeds": args.seeds,
                      "level": args.level, "device": str(dev)}))
    return summary


if __name__ == "__main__":
    main()
