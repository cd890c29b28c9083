"""Clustering: k-means, mean shift, k-medoids.

Port of `onepiece_tpu/algorithm/clustering.py`. Plain functions on the
points' device: each iteration is one distance matrix (`ops/knn.
pairwise_sqdist`) and one product, at a fixed iteration count. The JAX
package draws its random initial centres from a PRNG key; here they come
from an explicit `torch.Generator`, drawn on the generator's device (a CPU
generator gives the same start on every device), or are given as indices
(`init`), so a caller can feed the same start to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.knn import pairwise_sqdist


def _initial_indices(generator: torch.Generator | None, valid: torch.Tensor, k: int,
                     init: torch.Tensor | None) -> torch.Tensor:
    """k distinct valid indices: `init` if given, else the top k of
    Gumbel noise drawn from `generator` (random distinct valid points)."""
    if init is not None:
        return torch.as_tensor(init, dtype=torch.int64, device=valid.device)
    if generator is None:
        raise ValueError("pass a torch.Generator or the initial indices")
    u = torch.rand(valid.shape[0], generator=generator, device=generator.device).to(valid.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    return torch.topk(torch.where(valid, g, -torch.inf), k).indices


def kmeans(
    generator: torch.Generator | None,
    points: torch.Tensor,  # (N, D)
    valid: torch.Tensor,  # (N,) bool
    k: int,
    iters: int = 25,
    init: torch.Tensor | None = None,  # (k,) initial centre indices
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means: (centres (k, D), labels (N,), -1 where invalid).
    A cluster that empties keeps its centre."""
    centers = points[_initial_indices(generator, valid, k, init)]
    mask = valid[:, None].to(points.dtype)
    for _ in range(iters):
        labels = torch.argmin(pairwise_sqdist(points, centers), dim=-1)
        onehot = torch.nn.functional.one_hot(labels, k).to(points.dtype) * mask
        counts = onehot.sum(0)
        new = (onehot.T @ points) / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where(counts[:, None] > 0, new, centers)
    labels = torch.argmin(pairwise_sqdist(points, centers), dim=-1)
    return centers, torch.where(valid, labels, -1)


def mean_shift(
    points: torch.Tensor,  # (N, D)
    valid: torch.Tensor,
    bandwidth: float,
    iters: int = 30,
) -> torch.Tensor:
    """Gaussian-kernel mean shift: each point's mode (N, D)."""
    inv_bw2 = 1.0 / (bandwidth * bandwidth)
    w_valid = valid[None, :].to(points.dtype)
    modes = points
    for _ in range(iters):
        w = torch.exp(-0.5 * pairwise_sqdist(modes, points) * inv_bw2) * w_valid
        modes = (w @ points) / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    return modes


def mean_shift_clusters(points: torch.Tensor, valid: torch.Tensor, bandwidth: float, iters: int = 30):
    """`mean_shift`, then on the host: modes within bandwidth / 2 of a
    cluster's first mode join it. Returns (centres (C, D), labels (N,), -1
    where invalid) as numpy arrays."""
    modes = mean_shift(points, valid, bandwidth, iters).cpu().numpy()
    v = valid.cpu().numpy()
    labels = np.full(len(modes), -1, np.int64)
    centers: list[np.ndarray] = []
    for i in np.nonzero(v)[0]:
        for ci, c in enumerate(centers):
            if np.linalg.norm(modes[i] - c) < bandwidth * 0.5:
                labels[i] = ci
                break
        else:
            labels[i] = len(centers)
            centers.append(modes[i])
    return (np.stack(centers) if centers else np.zeros((0, points.shape[-1]))), labels


def kmedoids(
    generator: torch.Generator | None,
    points: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    iters: int = 15,
    init: torch.Tensor | None = None,  # (k,) initial medoid indices
) -> tuple[torch.Tensor, torch.Tensor]:
    """PAM-lite k-medoids: alternate assignment and, per cluster, the member
    with the least summed distance to the other members. Returns (medoid
    indices (k,), labels (N,), -1 where invalid).

    Keeps two N x N float32 matrices (the distances, and a copy with the
    invalid columns at 0), 8 N^2 bytes, and holds about 20 N^2 bytes at the
    peak while they are built: N = 20,000 peaks near 8 GB, and an 80 GB
    card fits N up to about 60,000."""
    medoids = _initial_indices(generator, valid, k, init)
    d_all = torch.where(valid[None, :], pairwise_sqdist(points, points), torch.inf)
    # a column of an invalid point never enters a sum: 0 keeps the product finite
    d_sum = torch.where(valid[None, :], d_all, 0.0)
    for _ in range(iters):
        labels = torch.argmin(d_all[:, medoids], dim=-1)
        member = (torch.nn.functional.one_hot(labels, k).bool() & valid[:, None]).T  # (k, N)
        costs = member.to(points.dtype) @ d_sum.T  # (k, N): candidate n's summed distance to cluster c
        medoids = torch.argmin(torch.where(member, costs, torch.inf), dim=-1)
    labels = torch.argmin(d_all[:, medoids], dim=-1)
    return medoids, torch.where(valid, labels, -1)
