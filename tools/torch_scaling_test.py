#!/usr/bin/env python3
"""Sharded modules at several world sizes, held to world 1, with what each
collective moved (the port's `tools/scaling_test.py`).

    python3 tools/torch_scaling_test.py                     # on the card, 640x480
    python3 tools/torch_scaling_test.py --device cpu        # CPU processes, 80x60

It spawns the ranks once (`parallel/launch.spawn`, as many as the largest
world; `--backend` for every world: gloo by default, which on the card
stages each collective through host memory; NCCL needs one card per
rank) and, for each world in `--worlds` (default 1 2 4), over the
subgroup of its first ranks, runs every module of `parallel/drive.MODULES`:
pixel-sharded dense tracking, block-sharded TSDF integration, the
slot-sharded fused TSDF step with ring-halo marching cubes and the
all_to_all migration, point-sharded BA and edge-sharded pose-graph
Gauss-Newton, on one set of inputs rendered once. Each world is held to
world 1: tracking within 1e-5, TSDF, the fused pool and the mesh bit for
bit (the mesh after migration as a sorted set), BA within 1e-4 relative,
the pose graph within 1e-5. Then the submap pipeline with one submap a
rank (`--submap-world`, default 4) against its serial run in this process.

It prints, per world and module, each collective's calls, the bytes rank 0
put in (per step where the module loops), the bytes staged through the host
and the time the calls took on rank 0 (CUDA events on the card, with the
card's name and power limit; the host clock on the CPU). It makes no claim
about other interconnects: the numbers are this machine's.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from onepiece_tpu_torch.geometry.camera import TUM_CAMERA  # noqa: E402
from onepiece_tpu_torch.odometry import dense  # noqa: E402
from onepiece_tpu_torch.ops.image import bilateral_filter  # noqa: E402
from onepiece_tpu_torch.parallel import drive, launch  # noqa: E402
from onepiece_tpu_torch.parallel import submap as psubmap  # noqa: E402
from onepiece_tpu_torch.utils import synthetic  # noqa: E402

TRACK_TOL = 1e-5
BA_TOL = 1e-4
PG_TOL = 1e-5
SUBMAP_TOL_M = 1e-3
TIMEOUT_S = 600.0
# on the card / on the CPU: the camera's downscale, the fused frames, the
# pool's blocks, the first touched-key cap, the frames a submap and the
# submap cloud's capacity
SIZES = dict(cuda=(1, 16, 16384, 8192, 50, 16384), cpu=(8, 3, 2048, 1024, 3, 1024))


def inputs(cam, dev: str, frames: int, capacity: int, kmax: int) -> dict:
    """One set of inputs for every world: the synthetic pair, blocks in front
    of the camera, `frames` orbit frames fused at their true poses into a
    pool of `capacity` blocks (`kmax` touched keys first), a BA problem (64 points a rank at world 4)
    and the pose-graph ring."""
    pair = drive.render_pair(cam, dev)
    scene = synthetic.default_scene(dev)
    poses = synthetic.orbit_trajectory(16)[:frames]
    fr = [synthetic.render(scene, torch.from_numpy(p).to(dev), cam.fx, cam.fy, cam.cx, cam.cy, cam.height,
                           cam.width, num_steps=48) for p in poses]
    rng = np.random.default_rng(0)
    F, P, omax = 8, 256, 3
    pts = (rng.uniform(-0.5, 0.5, (P, 3)) + np.array([0, 0, 2.0])).astype(np.float32)
    frame_pp = rng.integers(0, F, (P, omax))
    xi = np.concatenate([rng.normal(0, 0.05, (F, 3)), rng.normal(0, 0.02, (F, 3))], 1).astype(np.float32)
    xi[0] = 0
    T = dense.se3.se3_exp(torch.from_numpy(xi)).numpy()
    pc = np.einsum("poij,poj->poi", T[frame_pp][..., :3, :3], np.broadcast_to(pts[:, None], (P, omax, 3))) \
        + T[frame_pp][..., :3, 3]
    uv = pc[..., :2] / pc[..., 2:] * 300.0 + np.array([160.0, 120.0]) + rng.normal(0, 0.5, (P, omax, 2))
    noise = np.concatenate([rng.normal(0, 0.002, (F, 3)), rng.normal(0, 0.001, (F, 3))], 1).astype(np.float32)
    noise[0] = 0  # BA from near the solution: pose 0 holds the gauge, the others and the points perturbed
    ba = dict(poses=np.einsum("fij,fjk->fik", dense.se3.se3_exp(torch.from_numpy(noise)).numpy(), T),
              points=pts + rng.normal(0, 0.01, pts.shape).astype(np.float32), frame_pp=frame_pp,
              uv_pp=uv.astype(np.float32), mask_pp=np.ones((P, omax), bool), lam=1e-4,
              intr=(300.0, 300.0, 160.0, 120.0))
    T0 = np.linalg.inv(poses[0])
    fused = dict(depths=np.stack([bilateral_filter(d).cpu().numpy() for d, _ in fr]),
                 grays=np.stack([g.cpu().numpy() for _, g in fr]),
                 poses=np.stack([T0 @ p for p in poses]).astype(np.float32), capacity=capacity,
                 table_size=1 << 16, voxel_size=0.0125 * 640 / cam.width, truncation=0.1 * 640 / cam.width,
                 kmax=kmax, stride=8 * cam.width // 640 or 1, claim_rounds=(12, 2))
    return dict(camera=cam, dense=pair, tsdf=drive.tsdf_inputs(cam, pair["src_depth"], 1024), fused=fused, ba=ba,
                posegraph=drive.ring_posegraph())


def check(world: int, got: dict, ref: dict) -> None:
    dT = np.abs(got["dense"]["T"] - ref["dense"]["T"]).max()
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()  # noqa: E731
    fails = [name for name, ok in (
        ("dense", dT <= TRACK_TOL and got["dense"]["inliers"] == ref["dense"]["inliers"]),
        ("tsdf", got["tsdf"]["digest"] == ref["tsdf"]["digest"]),
        ("fused", (got["fused"]["pool_digest"], got["fused"]["table_digest"])
         == (ref["fused"]["pool_digest"], ref["fused"]["table_digest"])),
        ("mc", got["mc"]["digest"] == ref["mc"]["digest"] and got["mc"]["sorted_digest_after"]
         == ref["mc"]["sorted_digest"] and got["mc"]["overflow_after"] == 0),
        ("ba", max(rel(got["ba"][k], ref["ba"][k]) for k in ("poses", "points")) <= BA_TOL),
        ("posegraph", np.abs(got["posegraph"]["poses"] - ref["posegraph"]["poses"]).max() <= PG_TOL),
    ) if not ok]
    if fails:
        raise AssertionError(f"world {world}: {fails} disagree with world 1")


def steps(name: str) -> int:
    """A module's steps: the collectives it calls a step, printed per step."""
    return {"dense": sum(dense.DEFAULT_ITERS), "posegraph": drive.ring_posegraph()["iters"]}.get(name, 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="gloo")
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--submap-world", type=int, default=4)
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    scale, fused_frames, capacity, kmax, f, cloud_capacity = SIZES[args.device]
    cam = TUM_CAMERA.pyramid(scale.bit_length())[-1]
    card = ""
    if not cpu:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(card)
    if 1 not in args.worlds:
        raise SystemExit("--worlds must include 1: every world is held to it")
    if cpu:
        torch.set_num_threads(1)  # as the ranks: the serial submap run then sums in their order
    inp = inputs(cam, args.device, fused_frames, capacity, kmax)
    # the submap axis: one submap a rank against the serial run of the same stages
    s = args.submap_world
    scene = synthetic.default_scene(args.device)
    fr = [synthetic.render(scene, torch.from_numpy(p).to(args.device), cam.fx, cam.fy, cam.cx, cam.cy,
                           cam.height, cam.width, num_steps=48) for p in synthetic.loop_trajectory(s * f)]
    gs = np.stack([g.cpu().numpy() for _, g in fr]).reshape(s, f, cam.height, cam.width)
    ds = np.stack([d.cpu().numpy() for d, _ in fr]).reshape(s, f, cam.height, cam.width)
    kw = dict(cloud_capacity=cloud_capacity)
    ser = psubmap.submap_pipeline_serial(gs, ds, cam, args.device, **kw)

    worlds = tuple(sorted(args.worlds))
    n = max(*worlds, s)
    print(f"{cam.width}x{cam.height}, {args.backend} on {args.device}; worlds {list(worlds)}, the submap axis "
          f"over {s}: one spawn of {n} ranks, each world over the subgroup of its first ranks")
    t = time.perf_counter()
    ranks = launch.spawn(n, drive.run_worlds, inp, worlds, dict(grays=gs, depths=ds, camera=cam, kwargs=kw), s,
                         backend=args.backend, device=args.device, timeout=TIMEOUT_S)
    print(f"the spawn took {time.perf_counter() - t:.1f} s with the ranks' start")
    ref = ranks[0]["modules"][1]
    for world in worlds:
        r0 = ranks[0]["modules"][world]
        if world > 1:
            check(world, r0, ref)
        print(f"world {world}: every module {'agrees with world 1' if world > 1 else 'ran'}")
        for name, res in r0.items():
            k = steps(name)
            per = "; ".join(f"{c}: {v['calls'] // k}x {v['bytes'] // k} B a step ({v['staged_bytes'] // k} B staged), "
                            f"{v['ms'] / k:.3f} ms a step" for c, v in res["comm"].items() if v["calls"])
            print(f"  {name}: {res['seconds'] * 1e3:.1f} ms on rank 0; collectives of rank 0: {per or 'none'}"
                  + (f" on {card}" if card and per else ""))

    sh = ranks[0]["submap"]
    err = np.abs(sh["out"]["frame_poses"][:, :3, 3] - ser.frame_poses[:, :3, 3]).max()
    equal = np.array_equal(sh["out"]["frame_poses"], ser.frame_poses)
    print(f"submap axis ({s} submaps x {f} frames): sharded against serial max |dt| {err:.3g} m, bit-equal {equal}; "
          f"{sh['seconds']:.2f} s on rank 0; collectives of rank 0: "
          + "; ".join(f"{c}: {v['calls']}x {v['bytes']} B ({v['staged_bytes']} B staged), {v['ms']:.3f} ms"
                      for c, v in sh["comm"].items() if v["calls"]) + (f" on {card}" if card else ""))
    if not err <= SUBMAP_TOL_M:
        raise AssertionError(f"submap axis: sharded against serial {err} m > {SUBMAP_TOL_M}")
    print("scaling test ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
