#!/usr/bin/env python3
"""Synthetic exercises of the batched RANSAC engines (the port's
`tools/ransac_test.py`).

    python3 tools/torch_ransac_test.py                      # on the card
    python3 tools/torch_ransac_test.py --n-points 200 --device cpu

Makes seeded noisy correspondences with a share of outliers, fits the rigid
transform with `ops/ransac.ransac_rigid` (RANSAC3d's equivalent) and a plane
with `ransac_plane`, filters the pixel matches of a homography with
`homography_filter`, prints each recovered model against the ground truth
and asserts it: rotation error < 1 deg and translation error < 20 mm, plane
normal error < 2 deg, the homography filter keeping >= 90 % of the inliers
and < 10 % of the outliers. Random draws come from a generator seeded
`--seed` on the run's device.
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
from onepiece_tpu_torch.ops.ransac import homography_filter, ransac_plane, ransac_rigid  # noqa: E402

XI_GT = (0.1, -0.2, 0.15, 0.2, -0.1, 0.3)  # the rigid case's motion (twist)
H_GT = ((1.02, 0.05, 12.0), (-0.04, 0.98, -7.0), (1e-4, -5e-5, 1.0))  # the homography case's


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-points", type=int, default=400)
    ap.add_argument("--outlier-ratio", type=float, default=0.4)
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument("--num-hypotheses", type=int, default=512)
    ap.add_argument("--threshold", type=float, default=0.03)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = args.n_points
    n_out = int(n * args.outlier_ratio)
    ones = torch.ones(n, dtype=torch.bool, device=dev)

    def on(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    # -- the rigid transform with outliers (ref RansacTest rigid mode) --
    src = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    T_gt = se3.se3_exp(torch.tensor(XI_GT)).numpy()
    dst = src @ T_gt[:3, :3].T + T_gt[:3, 3] + rng.normal(0, args.noise, (n, 3)).astype(np.float32)
    dst[:n_out] = rng.uniform(-2, 2, (n_out, 3))
    res = ransac_rigid(gen, on(src), on(dst), ones, threshold=args.threshold, num_hypotheses=args.num_hypotheses,
                       sample_size=8)
    T_est = res.T.cpu().numpy()
    rot_err = float(np.rad2deg(np.arccos(np.clip((np.trace(T_est[:3, :3].T @ T_gt[:3, :3]) - 1) / 2, -1, 1))))
    t_err = float(np.linalg.norm(T_est[:3, 3] - T_gt[:3, 3]))
    print(f"rigid:  inliers={int(res.num_inliers)}/{n} rot_err={rot_err:.3f} deg  t_err={t_err * 1000:.2f} mm")
    assert rot_err < 1.0 and t_err < 0.02, "rigid RANSAC failed to recover the pose"

    # -- the plane with outliers (ref RansacTest / FitPlaneRANSAC) --
    pts = np.zeros((n, 3), np.float32)
    pts[:, :2] = rng.uniform(-1, 1, (n, 2))
    nrm = np.array([0.2, -0.3, 0.93])
    nrm /= np.linalg.norm(nrm)
    d0 = 0.4  # z such that n . p + d0 = 0 for the inliers
    pts[:, 2] = -(pts[:, 0] * nrm[0] + pts[:, 1] * nrm[1] + d0) / nrm[2]
    pts += rng.normal(0, args.noise, pts.shape).astype(np.float32)
    pts[:n_out] = rng.uniform(-2, 2, (n_out, 3))
    plane, inl = ransac_plane(gen, on(pts), ones, threshold=args.threshold, num_hypotheses=args.num_hypotheses)
    model = plane.cpu().numpy()
    ang = float(np.rad2deg(np.arccos(np.clip(abs(model[:3] / np.linalg.norm(model[:3]) @ nrm), -1, 1))))
    print(f"plane:  inliers={int(inl.sum())}/{n} normal_err={ang:.3f} deg")
    assert ang < 2.0, "plane RANSAC failed to recover the normal"

    # -- the homography filter of pixel matches (ref OutlierFilter::Ransac) --
    uv = rng.uniform(0, 640, (n, 2))
    H = np.asarray(H_GT)
    proj = np.c_[uv, np.ones(n)] @ H.T
    uv2 = proj[:, :2] / proj[:, 2:] + rng.normal(0, 1.0, (n, 2))
    uv2[:n_out] = rng.uniform(0, 640, (n_out, 2))
    keep = homography_filter(gen, on(uv), on(uv2), ones, num_hypotheses=args.num_hypotheses).cpu().numpy()
    kept_in, kept_out = float(keep[n_out:].mean()), float(keep[:n_out].mean()) if n_out else 0.0
    print(f"homography: kept {int(keep.sum())}/{n} ({kept_in:.3f} of the inliers, {kept_out:.3f} of the outliers)")
    assert kept_in >= 0.9 and kept_out < 0.1, "homography filter failed to separate the matches"
    print("PASS")
    return dict(rot_err_deg=rot_err, t_err_m=t_err, rigid_inliers=int(res.num_inliers), normal_err_deg=ang,
                plane_inliers=int(inl.sum()), homography_kept_inliers=kept_in, homography_kept_outliers=kept_out)


if __name__ == "__main__":
    main()
