"""Room segmentation over a wall-line arrangement.

Port of `onepiece_tpu/algorithm/rooms.py` (ref: example/RoomDetection.cpp
`Building::ComputeWeightsForEachEdge` / `ComputeEmbedding`): wall evidence
weights the arrangement's edges on the host, a diffusion over the
face-adjacency graph builds an embedding on the device (a matrix power and
`eigh`), and k-means over the embedding labels the faces with rooms.

The embedding's columns are eigenvectors, defined up to sign (and, at a
repeated eigenvalue, up to a rotation within its eigenspace): two packages
agree on the labels it gives, not on its numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dcel
from .clustering import kmeans


def edge_wall_evidence(
    arr: dcel.Arrangement,
    wall_points: np.ndarray,  # (N, 2) projected wall points
    max_dist: float = 0.1,
) -> np.ndarray:
    """Fraction of each edge covered by nearby wall points (ref
    ComputeWeightsForEachEdge: evidence that an arrangement edge is a real
    wall), on the host."""
    out = np.zeros(len(arr.edges))
    if len(wall_points) == 0:
        return out
    for ei, (u, v) in enumerate(arr.edges):
        a, b = arr.vertices[u], arr.vertices[v]
        d = b - a
        L = np.linalg.norm(d)
        if L < 1e-9:
            continue
        t = np.clip((wall_points - a) @ d / (L * L), 0.0, 1.0)
        proj = a + t[:, None] * d
        dist = np.linalg.norm(wall_points - proj, axis=-1)
        near = t[dist < max_dist]
        if len(near) == 0:
            continue
        # covered fraction via histogram of projections
        bins = max(int(L / max_dist), 1)
        hist = np.histogram(near, bins=bins, range=(0, 1))[0]
        out[ei] = (hist > 0).mean()
    return out


def diffusion_embedding(affinity: torch.Tensor, dim: int = 8, steps: int = 8) -> torch.Tensor:
    """Diffusion-map embedding (F, dim) of a face-affinity matrix (F, F),
    float32 on its device: the row-normalised matrix to the power `steps`,
    symmetrised, and its eigenvectors 2..dim+1 from the top, each scaled by
    its eigenvalue."""
    a = affinity.to(torch.float32)
    p = a / torch.clamp(a.sum(-1), min=1e-9)[:, None]
    pk = torch.linalg.matrix_power(p, steps)
    evals, evecs = torch.linalg.eigh((pk + pk.T) * 0.5)
    return evecs[:, -dim - 1 : -1] * evals[-dim - 1 : -1]


def detect_rooms(
    arr: dcel.Arrangement,
    wall_points: np.ndarray,
    num_rooms: int,
    wall_dist: float = 0.1,
    device: str | torch.device = "cuda",
    init: torch.Tensor | None = None,
) -> np.ndarray:
    """Label each arrangement face with a room id (ref RoomDetection.cpp).
    The embedding and k-means run on `device`; k-means starts from a CPU
    generator seeded 0 (the same start on every device), or from the face
    indices `init`."""
    nf = len(arr.faces)
    if nf == 0:
        return np.zeros(0, np.int64)
    evidence = edge_wall_evidence(arr, wall_points, wall_dist)
    aff = np.zeros((nf, nf))
    for fa, fb, e in dcel.face_adjacency(arr):
        w = np.exp(-4.0 * evidence[e])  # strong wall -> weak affinity
        aff[fa, fb] = aff[fb, fa] = w
    np.fill_diagonal(aff, 1.0)
    emb = diffusion_embedding(torch.from_numpy(aff).to(device), dim=min(8, nf - 1) if nf > 1 else 1)
    _, labels = kmeans(torch.Generator().manual_seed(0), emb, torch.ones(nf, dtype=torch.bool, device=emb.device),
                       k=min(num_rooms, nf), iters=50, init=init)
    return labels.cpu().numpy()
