#!/usr/bin/env python3
"""This tree's Hamming kernels and sparse path against another tree's, on one card.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/compare_torch_hamming.py --parent build/parent [--rounds 2]

Renders the 16-frame 640x480 orbit and the 100-frame `loop_trajectory`
(as `chip_smoke.py` phase 9 does), then, in turns (other, this, this,
other, per round):

  1. the kernels at the sparse path's shapes (`chip_smoke.hamming_forms`,
     `chip_smoke.mild_args`): `hamming_match` on orbit frames 0 and 1,
     unwindowed and windowed (20 px), on an all-valid 1000 x 1000 pair, and
     `mild_feature_scores` at the loop's 1000 x (128 x 1000), g = 39. Each
     tree's output is held equal to this tree's plain version (MILD within
     1e-5 relative). Per call: the kernel's device time from the profiler
     (CUPTI, kernel names `hamming_match_kernel` and
     `mild_feature_scores_kernel` in both trees), the other kernels the
     call launches (the wrapper's casts; this tree's must launch none, or
     the tool fails),
     CUDA-event time of back-to-back calls, and the launch floor (a
     one-element `fill_` in the same profiler session);
  2. `FusedFBASlam` (defaults) on the orbit in one chunk and on the loop
     in chunks of 25: ATE, keyframes, LC edges, ms per frame (host clock,
     one warm run first). The two trees' trajectories must be equal.

The other tree's package is imported under another name and builds its
kernels into its own `build/kernels/`. Needs a CUDA device; prints the
card's name and power limit, and one JSON line of the results last.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np
import torch

import chip_smoke
from compare_torch_mesh import OTHER, import_other
from onepiece_tpu_torch import _build
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA as CAM
from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.lcdetection import mild
from onepiece_tpu_torch.ops import hamming
from onepiece_tpu_torch.systems.fused_sparse import FusedFBASlam
from onepiece_tpu_torch.utils import synthetic


def render(scene, poses, dev):
    frames = [synthetic.render(scene, torch.from_numpy(p).to(dev), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                               CAM.height, CAM.width, num_steps=chip_smoke.RENDER_STEPS) for p in poses]
    return torch.stack([g for _, g in frames]), torch.stack([d for d, _ in frames])


def run_slam(cls, dev, grays, depths, chunk):
    torch.cuda.synchronize()
    t = time.perf_counter()
    s = cls(CAM, device=dev)
    for i in range(0, len(grays), chunk):
        s.process_chunk(grays[i : i + chunk], depths[i : i + chunk])
    torch.cuda.synchronize()
    return s, (time.perf_counter() - t) * 1e3 / len(grays)


def kernel_times(fn, name: str) -> dict:
    """Device ms of kernel `name`, kernels launched per call, launch floor,
    and CUDA-event ms of back-to-back calls."""
    t = chip_smoke.timed_beside_floor(fn, name)
    return dict(**t, event_ms=chip_smoke.cuda_ms(fn))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other tree (holding onepiece_tpu_torch/)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_hamming: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    import_other(Path(args.parent).resolve())
    o_ham = importlib.import_module(f"{OTHER}.ops.hamming")
    o_mild = importlib.import_module(f"{OTHER}.lcdetection.mild")
    o_sparse = importlib.import_module(f"{OTHER}.systems.fused_sparse")
    o_build = importlib.import_module(f"{OTHER}._build")
    _build.library()
    o_build.library()

    scene = synthetic.default_scene(dev)
    poses = synthetic.orbit_trajectory(chip_smoke.N_FRAMES)
    loop_gt = synthetic.loop_trajectory(chip_smoke.LOOP_FRAMES)
    grays, depths = render(scene, poses, dev)
    l_grays, l_depths = render(scene, loop_gt, dev)

    # -- the sparse path: each tree once warm, then timed in turns; trajectories equal --
    slams = {"other": o_sparse.FusedFBASlam, "this": FusedFBASlam}
    cells = {"orbit": (grays, depths, len(grays), poses), "loop": (l_grays, l_depths, chip_smoke.LOOP_CHUNK, loop_gt)}
    ests, loop_this = {}, None
    for name, cls in slams.items():
        for cell, (g_, d_, chunk, _) in cells.items():
            s, _ = run_slam(cls, dev, g_, d_, chunk)
            ests[name, cell] = s.trajectory()
            if name == "this" and cell == "loop":
                loop_this = s
    for cell in cells:
        if not np.array_equal(ests["other", cell], ests["this", cell]):
            raise AssertionError(f"{cell}: the two trees' trajectories differ "
                                 f"(max {np.abs(ests['other', cell] - ests['this', cell]).max()})")
    print("FusedFBASlam: the two trees' trajectories are equal on the orbit and the loop", flush=True)

    forms = chip_smoke.hamming_forms(CAM, dev, poses, grays, depths)
    margs = chip_smoke.mild_args(CAM, loop_this, l_grays, l_depths)
    plain = {form: hamming.hamming_match_reference(*a) for form, a in forms.items()}
    fp = mild.mild_feature_scores_reference(*margs)
    trees = {"other": (o_ham.hamming_match, o_mild.mild_feature_scores),
             "this": (hamming.hamming_match, mild.mild_feature_scores)}
    for name, (match, scores) in trees.items():
        for form, a in forms.items():
            k = match(*a)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(k, plain[form])):
                raise AssertionError(f"{name} hamming_match {form}: not equal to the plain version")
        fk = scores(*margs)
        torch.cuda.synchronize()
        rel = float((fk - fp).abs().max() / fp.abs().max())
        if not (rel <= 1e-5 and torch.equal(fk, scores(*margs))):
            raise AssertionError(f"{name} mild_feature_scores: rel err {rel} (<= 1e-5), or two calls differ")
        print(f"{name}: hamming_match equal to the plain version in the three forms, MILD rel err {rel:.3g}",
              flush=True)
    bounds = {form: chip_smoke.bound(*chip_smoke.hamming_bytes_ops(*a), chip_smoke.PEAK_POPC_PER_S)["bound_ms"]
              for form, a in forms.items()}
    bounds["mild"] = chip_smoke.bound(*chip_smoke.mild_bytes_ops(*margs), chip_smoke.PEAK_POPC_PER_S)["bound_ms"]

    kernel = {name: [] for name in trees}
    path = {name: [] for name in trees}
    order = ["other", "this", "this", "other"]
    for r in range(args.rounds):
        for name in order:
            match, scores = trees[name]
            row = {form: kernel_times(lambda a=a: match(*a), "hamming_match_kernel") for form, a in forms.items()}
            row["mild"] = kernel_times(lambda: scores(*margs), "mild_feature_scores_kernel")
            if name == "this":
                for f, t in row.items():
                    chip_smoke.require_one_kernel(t, f"round {r} this {f}")
            kernel[name].append(row)
            print(f"round {r} {name}: " + "; ".join(
                f"{f} {t['ms']:.4f} ms (share {bounds[f] / t['ms']:.3f}, {t['other']} other kernels a call, "
                f"events {t['event_ms']:.4f}, floor {t['floor_ms']})" for f, t in row.items()), flush=True)
            cell_res = {}
            for cell, (g_, d_, chunk, gt) in cells.items():
                s, ms = run_slam(slams[name], dev, g_, d_, chunk)
                est = s.trajectory()
                if not np.array_equal(est, ests["this", cell]):
                    raise AssertionError(f"round {r} {name} {cell}: the trajectory moved between runs")
                cell_res[cell] = dict(ate_mm=traj.ate_rmse(est, gt) * 1e3, keyframes=s.num_kf,
                                      lc_edges=s.lc_edges_total, ms_per_frame=ms)
            path[name].append(cell_res)
            print(f"round {r} {name}: " + "; ".join(
                f"{c} ATE {v['ate_mm']:.4f} mm, {v['keyframes']} keyframes, {v['lc_edges']} LC edges, "
                f"{v['ms_per_frame']:.3f} ms/frame" for c, v in cell_res.items()), flush=True)
    print(card)
    print(json.dumps({"card": card, "bound_ms": bounds, "kernels": kernel, "fused_fba_slam": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
