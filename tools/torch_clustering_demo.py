#!/usr/bin/env python3
"""Clustering on the PyTorch + CUDA port: k-means / mean shift / k-medoids over a point cloud.

    python3 tools/torch_clustering_demo.py                                 # synthetic blobs, k-means, on the card
    python3 tools/torch_clustering_demo.py cloud.ply clusters.ply --method meanshift --bandwidth 0.3
    python3 tools/torch_clustering_demo.py --method kmedoids --device cpu

The counterpart of `tools/clustering_demo.py` for `onepiece_tpu_torch`
(ref example/Clustering.cpp): cluster the PLY's points (or the same seeded
Gaussian blobs as the JAX tool: k blobs of 300 points) with
`algorithm/clustering.py` on the run's device, and write the cloud coloured
by label. The random initial centres come from a CPU `torch.Generator` seeded
with --seed, the same on every device (the JAX tool draws from
`PRNGKey(seed)`: other draws).
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_common import add_device_arg  # noqa: E402
from onepiece_tpu_torch.algorithm import clustering  # noqa: E402
from onepiece_tpu_torch.io.ply import read_ply, write_ply_pointcloud  # noqa: E402

LABEL_RGB = np.asarray(
    [[230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
     [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230]],
    np.float32,
) / 255.0


def synthetic_blobs(k: int, seed: int) -> np.ndarray:
    """k Gaussian blobs (sigma 0.15) of 300 points around centres uniform in
    [-2, 2]^3, float32 (k * 300, 3): the JAX tool's input."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (k, 3))
    return np.concatenate([c + rng.normal(0, 0.15, (300, 3)) for c in centers]).astype(np.float32)


def cluster(method: str, pts: torch.Tensor, k: int, bandwidth: float, generator: torch.Generator | None,
            init: torch.Tensor | None = None) -> np.ndarray:
    """Labels (N,) of `method` over the points, on their device."""
    valid = torch.ones(len(pts), dtype=torch.bool, device=pts.device)
    if method == "kmeans":
        return clustering.kmeans(generator, pts, valid, k=k, init=init)[1].cpu().numpy()
    if method == "kmedoids":
        return clustering.kmedoids(generator, pts, valid, k=k, init=init)[1].cpu().numpy()
    return clustering.mean_shift_clusters(pts, valid, bandwidth=bandwidth)[1]


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input", nargs="?", default="", help="PLY point cloud (default: synthetic blobs)")
    ap.add_argument("output", nargs="?", default="clusters.ply")
    ap.add_argument("--method", choices=["kmeans", "meanshift", "kmedoids"], default="kmeans")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--bandwidth", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    if args.input:
        pts = read_ply(args.input)["vertices"].astype(np.float32)
    else:
        pts = synthetic_blobs(args.k, args.seed)
        print(f"synthetic: {args.k} blobs x 300 points")
    gen = torch.Generator().manual_seed(args.seed)
    labels = cluster(args.method, torch.from_numpy(pts).to(args.device), args.k, args.bandwidth, gen)

    uniq = np.unique(labels[labels >= 0])
    print(f"{args.method}: {len(uniq)} clusters over {len(pts)} points")
    for u in uniq[:10]:
        print(f"  cluster {u}: {(labels == u).sum()} points")
    write_ply_pointcloud(args.output, pts, colors=LABEL_RGB[np.maximum(labels, 0) % len(LABEL_RGB)])
    print(f"labeled cloud -> {args.output}")
    return labels


if __name__ == "__main__":
    main()
