#!/usr/bin/env python3
"""Synthetic bundle-adjustment convergence test (the port's `tools/ba_test.py`).

    python3 tools/torch_ba_test.py                     # full BA, on the card
    python3 tools/torch_ba_test.py --mode posegraph --device cpu

Makes the JAX tool's seeded scene: a quarter circle of cameras round
random world points, noisy pixel projections, perturbed poses and
points. `full` optimises poses and points with `optimization/bundle.py
optimize` in the 2-D reprojection model (on the card each LM step's Schur
reduction is the kernel of `csrc/ba_schur.cu`) and prints each iteration's
cost, the final reprojection error beside the injected noise and the
largest pose error; `posegraph` optimises the perturbed poses over
point-pair edges with `optimization/posegraph.py` and prints the final
cost and pose error.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_common import add_device_arg  # noqa: E402
from onepiece_tpu_torch.geometry import se3  # noqa: E402
from onepiece_tpu_torch.optimization import bundle, posegraph  # noqa: E402

FX = FY = 300.0
CX, CY = 160.0, 120.0


def exp_np(xi: np.ndarray) -> np.ndarray:
    return se3.se3_exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()


def scene(n: int, num_points: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """(camera-to-world poses (n, 4, 4) on a quarter circle looking at the
    origin, world points (P, 3) uniform in [-0.8, 0.8]^3)."""
    T_wc = []
    for i in range(n):
        ang = 2 * np.pi * i / n * 0.25
        eye = np.array([2 * np.sin(ang), 0.2 * np.sin(2 * ang), -2 * np.cos(ang)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, np.cross(fwd, right), fwd, eye
        T_wc.append(T)
    return np.array(T_wc), rng.uniform(-0.8, 0.8, size=(num_points, 3))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--points", type=int, default=200)
    ap.add_argument("--pixel-noise", type=float, default=0.5)
    ap.add_argument("--pose-noise", type=float, default=0.05)
    ap.add_argument("--iters", type=int, default=bundle.DEFAULT_MAX_ITERS)
    ap.add_argument("--mode", choices=["full", "posegraph"], default="full")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    rng = np.random.default_rng(0)
    n = args.frames
    T_wc, pts = scene(n, args.points, rng)
    T_cw = np.linalg.inv(T_wc)
    pts_h = np.c_[pts, np.ones(len(pts))]

    if args.mode == "posegraph":
        edge_list = [{"src": i, "dst": j, "p_src": (T_cw[i] @ pts_h.T).T[:, :3], "p_dst": (T_cw[j] @ pts_h.T).T[:, :3]}
                     for i, j in [(k, k + 1) for k in range(n - 1)] + [(0, n - 1)]]
        edges = posegraph.build_edges(edge_list, corr_capacity=len(pts), device=dev)
        noise = rng.normal(size=(n, 6)) * args.pose_noise
        noise[0] = 0
        init = np.einsum("nij,njk->nik", exp_np(noise), T_wc)
        opt, cost = posegraph.optimize_pose_graph(torch.as_tensor(init, dtype=torch.float32, device=dev), edges,
                                                  iters=10)
        err = float(np.abs(opt.cpu().numpy() - T_wc).max())
        print(f"posegraph: final cost {float(cost):.3e}, max pose err {err:.3e}")
        return dict(cost=float(cost), pose_err=err)

    frames, pids, uvs = [], [], []
    for f in range(n):
        pc = (T_cw[f] @ pts_h.T).T[:, :3]
        z = pc[:, 2]
        u = pc[:, 0] / z * FX + CX
        v = pc[:, 1] / z * FY + CY
        ok = (z > 0.3) & (u > 0) & (u < 2 * CX) & (v > 0) & (v < 2 * CY)
        for p in np.nonzero(ok)[0]:
            frames.append(f)
            pids.append(p)
            uvs.append([u[p] + rng.normal() * args.pixel_noise, v[p] + rng.normal() * args.pixel_noise])
    obs = bundle.build_observations(np.array(frames), np.array(pids), np.array(uvs, np.float32), args.points,
                                    device=dev)
    pose_pert = rng.normal(size=(n, 6)) * args.pose_noise
    pose_pert[0] = 0
    init_poses = np.einsum("nij,njk->nik", exp_np(pose_pert), T_cw)
    init_points = pts + rng.normal(size=pts.shape) * 0.05
    problem = bundle.BAProblem(torch.as_tensor(init_poses, dtype=torch.float32, device=dev),
                               torch.as_tensor(init_points, dtype=torch.float32, device=dev), obs)
    opt, mse = bundle.optimize(problem, FX, FY, CX, CY, max_iters=args.iters, verbose=True)
    rms = float(np.sqrt(mse))
    err = float(np.abs(opt.poses.cpu().numpy() - T_cw).max())
    print(f"final mean reprojection error: {rms:.3f} px (injected noise {args.pixel_noise} px), obs {len(frames)}; "
          f"max pose err {err:.3e}")
    return dict(rms_px=rms, pose_err=err, observations=len(frames))


if __name__ == "__main__":
    main()
