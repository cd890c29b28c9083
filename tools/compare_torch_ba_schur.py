#!/usr/bin/env python3
"""This tree's BA Schur kernel and BAFusion path against another tree's, on one card.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/compare_torch_ba_schur.py --parent build/parent [--rounds 2]
    python3 tools/compare_torch_ba_schur.py --parent . --device cpu --level 2 --frames 4 --loop-frames 0 \
        --max-keypoints 300 --rounds 1

Renders the 16-frame 640x480 orbit and the 100-frame `loop_trajectory`
(as `chip_smoke.py` phases 9-10 do) and records, in a run of this tree's
`FusedBASlam`, the inputs of the BA steps that phase 10 holds: the orbit's
first step (one chunk) and the loop's last chunk's first step (chunks of
25). Then, in turns (other, this, this, other, per round):

  1. one LM step's Schur work on each recorded input with the tree's own
     `build_lists`, `reduced_system` and `back_substitute` (a fixed camera
     step dc), held to this tree's plain version within
     `chip_smoke.KERNEL2_TOL` (S, rhs_c, b_p, V^-1 of the observed points,
     dp). Per step: each kernel's device time from the profiler (CUPTI),
     the step's sum and launch B's (the kernel of `reduced_system` that is
     not `ba_points_kernel`: `ba_frames_kernel` or `ba_blocks_kernel`), and
     this tree's must launch no kernel but its three, or the tool fails;
  2. `FusedBASlam` (defaults) on the orbit in one chunk and on the loop in
     chunks of 25: ATE, world points, observations, ms per frame (host
     clock; on the card each tree once warm first). This tree's runs must
     repeat bit for bit.

The other tree's package is imported under another name and builds its
kernels into its own `build/kernels/`. Prints the card's name and power
limit, then one JSON line of the results last, with the bound of each step
(`chip_smoke.ba_bytes_ops`, over the capacities) and launch B's speed-up
(the other tree's median over this tree's). With `--device cpu` the
wrappers run their plain versions: no device time is measured (null), the
host ms of a step is reported instead, and `--level`, `--frames`,
`--loop-frames` (0: no loop) and `--max-keypoints` cut the run to a smoke
test (keyframe disparity scaled with the level).
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
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
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.ops import ba_schur
from onepiece_tpu_torch.systems import fused_ba
from onepiece_tpu_torch.systems.fused_sparse import KEYFRAME_DISPARITY
from onepiece_tpu_torch.utils import synthetic

POINTS_KERNEL = "ba_points_kernel"
BACK_KERNEL = "ba_back_substitute_kernel"


def render(scene, poses, cam, dev, steps: int):
    frames = [synthetic.render(scene, torch.from_numpy(p).to(dev), cam.fx, cam.fy, cam.cx, cam.cy,
                               cam.height, cam.width, num_steps=steps) for p in poses]
    return torch.stack([g for _, g in frames]), torch.stack([d for d, _ in frames])


def run_slam(cls, cam, dev, grays, depths, chunk: int, opts: dict):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    s = cls(cam, device=dev, **opts)
    for i in range(0, len(grays), chunk):
        s.process_chunk(grays[i : i + chunk], depths[i : i + chunk])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return s, (time.perf_counter() - t) * 1e3 / len(grays)


def record_step(cam, dev, grays, depths, chunk: int, opts: dict, last_chunk: bool) -> tuple:
    """The inputs of this tree's FusedBASlam's first BA step (or its last
    chunk's first), cloned: the linker writes the track buffers in place."""
    calls = []

    def recording(fn):
        def wrapped(*args, **kwargs):
            calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args[:9]))
            return fn(*args, **kwargs)
        return wrapped

    with chip_smoke.patched(ba_schur, "reduced_system", recording):
        run_slam(fused_ba.FusedBASlam, cam, dev, grays, depths, chunk, opts)
    if not calls:
        raise AssertionError("FusedBASlam made no BA step on these frames")
    return calls[-chip_smoke.BA_ITERS] if last_chunk else calls[0]


def lists_of(mod, args):
    return mod.build_lists(args[2], args[3], args[5], args[0].shape[0], args[1].shape[0])


def step(mod, args, lists, dc):
    s = mod.reduced_system(*args, lists=lists)
    return s, mod.back_substitute(s, dc, args[2], args[3], lists)


def kernel_ms(fn, calls: int = 20, attempts: int = 3) -> dict | None:
    """Each kernel's mean device ms per launch over `calls` fn() calls (each
    launched once a call), by the name before its argument list, from the
    profiler; None where no session recorded a kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:  # by the kernel's own name, not its signature
                m = re.search(r"(\w+)\(", e.name)
                name = m.group(1) if m else e.name
                us.setdefault(name, []).append(e.time_range.elapsed_us())
        if us:
            return {k: float(np.mean(v)) / 1e3 for k, v in us.items()}
    return None


def host_ms(fn, reps: int = 3) -> float:
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other tree (holding onepiece_tpu_torch/)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--level", type=int, default=0, help="pyramid level of the frames (0: 640x480)")
    ap.add_argument("--frames", type=int, default=chip_smoke.N_FRAMES, help="orbit frames, one chunk")
    ap.add_argument("--loop-frames", type=int, default=chip_smoke.LOOP_FRAMES,
                    help="loop frames in chunks of 25 (0: no loop)")
    ap.add_argument("--max-keypoints", type=int, default=None, help="FusedBASlam's (default: its own)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("compare_torch_ba_schur: needs a CUDA device (or --device cpu)", file=sys.stderr)
        return 1
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
            if dev.type == "cuda" else "cpu")
    print(card, flush=True)
    import_other(Path(args.parent).resolve())
    o_schur = importlib.import_module(f"{OTHER}.ops.ba_schur")
    o_ba = importlib.import_module(f"{OTHER}.systems.fused_ba")
    if dev.type == "cuda":
        _build.library()
        importlib.import_module(f"{OTHER}._build").library()

    cam = TUM_CAMERA.pyramid(args.level + 1)[args.level]
    opts = dict(keyframe_disparity=KEYFRAME_DISPARITY / 2**args.level)
    if args.max_keypoints is not None:
        opts["max_keypoints"] = args.max_keypoints
    steps = chip_smoke.RENDER_STEPS if args.level == 0 else 24
    scene = synthetic.default_scene(dev)
    gt = {"orbit": synthetic.orbit_trajectory(args.frames)}
    frames = {"orbit": (*render(scene, gt["orbit"], cam, dev, steps), args.frames)}
    if args.loop_frames:
        gt["loop"] = synthetic.loop_trajectory(args.loop_frames)
        frames["loop"] = (*render(scene, gt["loop"], cam, dev, steps), chip_smoke.LOOP_CHUNK)
    calls = {cell: record_step(cam, dev, g, d, chunk, opts, cell == "loop")
             for cell, (g, d, chunk) in frames.items()}

    trees = {"other": (o_schur, o_ba.FusedBASlam), "this": (ba_schur, fused_ba.FusedBASlam)}
    dcs, plain, bounds = {}, {}, {}
    for cell, a in calls.items():
        dcs[cell] = torch.from_numpy(np.random.default_rng(0).normal(size=6 * a[0].shape[0]).astype(np.float32)
                                     * 1e-3).to(dev)
        p = ba_schur.reduced_system_reference(*a)
        plain[cell] = (p, ba_schur.back_substitute_reference(p, dcs[cell], a[2], a[3]))
        lists = ba_schur.build_lists(a[2], a[3], a[5], a[0].shape[0], a[1].shape[0])
        n_bytes, n_ops, n_pairs = chip_smoke.ba_bytes_ops(a, lists)
        bounds[cell] = dict(**chip_smoke.bound(n_bytes, n_ops), pairs=n_pairs, frames=a[0].shape[0],
                            points=a[1].shape[0], observations=int(lists.frame_ptr[-1]))
    for name, (mod, cls) in trees.items() if dev.type == "cuda" else ():  # once warm: builds, allocator, handles
        for cell, (g, d, chunk) in frames.items():
            run_slam(cls, cam, dev, g, d, chunk, opts)

    order = ["other", "this", "this", "other"]
    kern = {name: {cell: [] for cell in calls} for name in trees}
    path = {name: {cell: [] for cell in calls} for name in trees}
    this_est = {}
    for r in range(args.rounds):
        for name in order:
            mod, cls = trees[name]
            for cell, a in calls.items():
                lists = lists_of(mod, a) if dev.type == "cuda" else None
                s, dp = step(mod, a, lists, dcs[cell])
                s2, dp2 = step(mod, a, lists, dcs[cell])
                p, pdp = plain[cell]
                observed = torch.zeros(a[1].shape[0], dtype=torch.bool, device=dev)
                observed[a[3][a[5]]] = True
                errs = {n: chip_smoke.rel_err(x, y) for n, (x, y) in dict(
                    S=(s.S, p.S), rhs_c=(s.rhs_c, p.rhs_c), b_p=(s.b_p, p.b_p),
                    Vinv=(s.Vinv[observed], p.Vinv[observed]), dp=(dp, pdp)).items()}
                same = all(torch.equal(x, y) for x, y in zip((*s[:4], dp), (*s2[:4], dp2)))
                if not (max(errs.values()) <= chip_smoke.KERNEL2_TOL and same):
                    raise AssertionError(f"round {r} {name} {cell}: rel errs {errs} (<= {chip_smoke.KERNEL2_TOL}), "
                                         f"two calls bit-equal {same}")
                row = dict(max_rel_err=max(errs.values()))
                if dev.type == "cuda":
                    ks = kernel_ms(lambda: step(mod, a, lists, dcs[cell]))
                    if ks is None:
                        raise AssertionError(f"round {r} {name} {cell}: the profiler recorded no kernel")
                    b_names = sorted(set(ks) - {POINTS_KERNEL, BACK_KERNEL})
                    if name == "this" and set(ks) != {*chip_smoke.BA_REDUCED_KERNELS, *chip_smoke.BA_BACK_KERNELS}:
                        raise AssertionError(f"round {r} this {cell}: kernels {sorted(ks)} (its own three only)")
                    row.update(kernels=ks, step_ms=sum(ks.values()), launch_b=b_names,
                               launch_b_ms=sum(ks[n] for n in b_names), host_ms=None)
                else:
                    row.update(kernels=None, step_ms=None, launch_b=None, launch_b_ms=None,
                               host_ms=host_ms(lambda: step(mod, a, lists, dcs[cell])))
                kern[name][cell].append(row)
                g, d, chunk = frames[cell]
                slam, ms = run_slam(cls, cam, dev, g, d, chunk, opts)
                est = slam.trajectory()
                if name == "this" and not np.array_equal(this_est.setdefault(cell, est), est):
                    raise AssertionError(f"round {r} this {cell}: the trajectory moved between runs")
                path[name][cell].append(dict(ate_mm=traj.ate_rmse(est, gt[cell]) * 1e3, keyframes=slam.num_kf,
                                             points=slam.n_pts, observations=slam.n_obs, ms_per_frame=ms))
                print(f"round {r} {name} {cell}: step {row['step_ms']} ms on the device (launch B {row['launch_b']} "
                      f"{row['launch_b_ms']}; kernels {row['kernels']}; host ms {row['host_ms']}), rel err "
                      f"{row['max_rel_err']:.3g}, two calls bit-equal; FusedBASlam {path[name][cell][-1]}", flush=True)
    speedup = None
    if dev.type == "cuda":
        speedup = {cell: float(np.median([x["launch_b_ms"] for x in kern["other"][cell]])
                               / np.median([x["launch_b_ms"] for x in kern["this"][cell]])) for cell in calls}
    print(f"launch B speed-up, the other tree's median over this tree's: {speedup} on {card}", flush=True)
    print(card)
    print(json.dumps({"card": card, "device": dev.type, "bound": bounds, "launch_b_speedup": speedup,
                      "steps": kern, "fused_ba_slam": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
