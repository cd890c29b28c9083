"""Region-growing line (2D) and plane (3D) detection.

Port of `onepiece_tpu/algorithm/patch_detection.py` (ref:
src/Algorithm/PatchDetection.{h,cpp}). Per-point local models from
neighbourhood fits (two inlier-refit rounds), seeds in order of lowest
local residual, then BFS region growing: a candidate joins if it lies
within `residual_threshold` of the patch model AND its local normal is
within |dot| >= 0.8 of the patch normal. The patch model is refit once per
FRONTIER NODE, not per candidate, and a visited candidate is CONSUMED even
when it is rejected (the reference erases it from `un_visited` first).

The local fits are one batched float64 moment and `eigh` computation on the
device of the kNN lists (`local_models`). The BFS is host control flow over
numpy copies; each refit is O(D^3) from running sums (count, sum p, sum
p p^T), in the JAX package's order, so a patch's model is the same numbers.
An eigenvector is defined up to its sign, and the device's `eigh` may pick
the other one than numpy's: every use of a local normal here (the distance
|n . p + d| and |n_local . n_patch|) is sign-free.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch


@dataclasses.dataclass
class Patch:
    indices: np.ndarray  # member point indices
    model: np.ndarray  # line: (origin, dir) flat 2D + 2D; plane: (n, d) 4


def _models_from_cov(mu: np.ndarray, cov: np.ndarray):
    """(n, d) hyperplane, principal direction and rms residual of one set of
    moments on the host: mu (D,), cov (D, D) central covariance."""
    w, v = np.linalg.eigh(cov)
    normal = v[..., 0]  # smallest-variance direction
    direction = v[..., -1]  # largest (line tangent / plane major axis)
    d = -np.einsum("...i,...i->...", normal, mu)
    rms = np.sqrt(np.maximum(w[..., 0], 0.0))
    return normal, d, direction, rms


def local_models(
    points: torch.Tensor,  # (N, D)
    neighbors: torch.Tensor,  # (N, K) kNN indices
    dist_threshold: float,
    refit_rounds: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point local hyperplane fits over the kNN lists, batched in
    float64 on `neighbors`' device: fit, keep the neighbours within the
    distance threshold, refit (`refit_rounds` times; ref
    PatchDetection.cpp:85-126). Returns (normals (N, D), rms residuals (N,))."""
    nb = points.to(device=neighbors.device, dtype=torch.float64)[neighbors]  # (N, K, D)
    w_mask = torch.ones(nb.shape[:2], dtype=torch.float64, device=nb.device)
    for _ in range(refit_rounds + 1):
        cnt = torch.clamp(w_mask.sum(1), min=1.0)
        mu = (nb * w_mask[..., None]).sum(1) / cnt[:, None]
        X = (nb - mu[:, None]) * w_mask[..., None]
        cov = torch.einsum("nki,nkj->nij", X, X) / cnt[:, None, None]
        w, v = torch.linalg.eigh(cov)
        normal = v[..., 0]
        d = -torch.einsum("ni,ni->n", normal, mu)
        dist = torch.abs(torch.einsum("nkd,nd->nk", nb, normal) + d[:, None])
        w_mask = (dist <= dist_threshold).to(torch.float64)
    return normal, torch.sqrt(torch.clamp(w[:, 0], min=0.0))


def detect_patches(
    points: torch.Tensor,  # (N, D) D=2 lines / D=3 planes
    neighbors: torch.Tensor,  # (N, K) kNN indices, on the device the local fits run on
    residual_threshold: float = 0.02,
    min_points: int = 20,
    max_patches: int = 64,
    normal_min_dot: float = 0.8,  # ref IsInlier normal_prod >= 0.8
) -> list[Patch]:
    """Seeded region growing with incremental patch statistics."""
    normals, local_res = (x.cpu().numpy() for x in local_models(points, neighbors, residual_threshold))
    pts = torch.as_tensor(points).cpu().numpy().astype(np.float64)
    neighbors = neighbors.cpu().numpy()
    n, d_dim = pts.shape

    order = np.argsort(local_res, kind="stable")
    unvisited = np.ones(n, bool)
    patches: list[Patch] = []
    for seed in order:
        if not unvisited[seed] or len(patches) >= max_patches:
            continue
        s1 = pts[seed].copy()
        s2 = np.outer(pts[seed], pts[seed])
        cnt = 1
        p_n = normals[seed]
        p_d = -p_n @ pts[seed]
        members = [int(seed)]
        frontier = deque([int(seed)])
        unvisited[seed] = False
        rms = np.inf
        while frontier:
            cur = frontier.popleft()
            for nb in neighbors[cur]:
                nb = int(nb)
                if not unvisited[nb]:
                    continue
                unvisited[nb] = False  # consumed even if rejected (ref :155)
                p = pts[nb]
                dist = abs(p_n @ p + p_d)
                tangent_ok = abs(normals[nb] @ p_n) >= normal_min_dot
                if dist > residual_threshold or not tangent_ok:
                    continue
                members.append(nb)
                frontier.append(nb)
                s1 += p
                s2 += np.outer(p, p)
                cnt += 1
            if cnt >= 3:
                mu = s1 / cnt
                cov = s2 / cnt - np.outer(mu, mu)
                p_n, p_d, _, rms = _models_from_cov(mu, cov)
        if cnt >= min_points and rms <= residual_threshold:
            idx = np.array(sorted(members))
            mu = s1 / cnt
            cov = s2 / cnt - np.outer(mu, mu)
            p_n, p_d, direction, _ = _models_from_cov(mu, cov)
            model = np.concatenate([p_n, [p_d]]) if d_dim == 3 else np.concatenate([mu, direction])
            patches.append(Patch(idx, model))
        # a failed patch's members stay consumed, as in the reference
    return patches
