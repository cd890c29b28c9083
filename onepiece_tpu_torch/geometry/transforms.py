"""Rigid-transform estimation and normal fitting, batched-first.

Port of `onepiece_tpu/geometry/transforms.py` (`kabsch`, `kabsch_fast`,
`fit_plane`, `fit_line`, `plane_point_distance`,
`estimate_normals_from_neighbors`). Every function takes a leading batch
of any shape: (..., N, 3) in, (..., 4, 4) or (..., 3) out.
"""

from __future__ import annotations

import torch

from ..utils import tracing
from .se3 import make_T

POWER_ITERS = 32  # kabsch_fast: iterations of the power method (on K^4: 8 products)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors (no LU factorisation)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _centre(src, dst, weights):
    """Normalised weights, weighted means and centred clouds."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    mu_s = torch.sum(src * w[..., None], dim=-2)
    mu_d = torch.sum(dst * w[..., None], dim=-2)
    return w, mu_s, mu_d, src - mu_s[..., None, :], dst - mu_d[..., None, :]


def kabsch(
    src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Weighted rigid transform T (..., 4, 4) minimising ||T(src) - dst||^2.

    Kabsch/Umeyama by SVD of the 3x3 covariance; the reflection case flips
    the smallest singular vector (D = diag(1, 1, det(U Vt)))."""
    w, mu_s, mu_d, sc, dc = _centre(src, dst, weights)
    H = torch.einsum("...ni,...nj->...ij", dc * w[..., None], sc)
    with tracing.sync("kabsch_svd", 2):  # on the card the library's SVD waits twice (sync debug mode "warn")
        U, _, Vt = torch.linalg.svd(H)
    det = _det3(U @ Vt)
    one = torch.ones_like(det)
    D = torch.diag_embed(torch.stack([one, one, det], dim=-1))
    R = U @ D @ Vt
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return make_T(R, t)


_START: dict = {}


def _start_vector(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The power iteration's start vector, copied to each device once (a
    copy from the host in the loop would wait for the device)."""
    key = (dtype, device)
    if key not in _START:
        _START[key] = torch.tensor([1.0, 0.01, 0.02, 0.03], dtype=dtype).to(device)
    return _START[key]


def kabsch_fast(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """`kabsch` without the SVD: Horn's quaternion method, the top
    eigenvector of a symmetric 4x4 found by an E0-shifted power iteration on
    its fourth power. Built for large hypothesis batches (RANSAC); matches
    `kabsch` on well-posed samples, and may converge slowly on degenerate
    (collinear) ones."""
    w, mu_s, mu_d, sc, dc = _centre(src, dst, weights)
    S = torch.einsum("...ni,...nj->...ij", sc * w[..., None], dc)
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    K = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], dim=-2)
    # shift by E0 = (|sc|^2 + |dc|^2) / 2 so that K + E0 I is positive
    # semi-definite with a usable eigen-gap
    e0 = 0.5 * (
        torch.sum(torch.sum(sc * sc, -1) * w, -1) + torch.sum(torch.sum(dc * dc, -1) * w, -1)
    )[..., None, None]
    with tracing.span(".eigenvector"):  # of the caller's layer
        Kp = K + e0 * torch.eye(4, dtype=K.dtype, device=K.device)
        K2 = Kp @ Kp
        K4 = K2 @ K2
        K4 = K4 / torch.clamp(torch.sqrt(torch.sum(K4 * K4, dim=(-2, -1), keepdim=True)), min=1e-30)
        v = _start_vector(K.dtype, K.device).expand(K.shape[:-1])
        for _ in range(max(1, (POWER_ITERS + 3) // 4)):
            v = (K4 @ v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
        qw, qx, qy, qz = v.unbind(-1)
        R = torch.stack([
            torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)], -1),
            torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)], -1),
            torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)], -1),
        ], dim=-2)
        t = mu_d - (R @ mu_s[..., None])[..., 0]
        return make_T(R, t)


def fit_plane(points: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted least-squares plane (n, d), |n| = 1, n.p + d = 0 (ref:
    Geometry.cpp:172-220 `FitPlane`): n is the smallest right-singular
    vector of the weighted, centred points. points (..., N, 3) -> (..., 4);
    the sign of (n, d) is the SVD's."""
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=points.dtype, device=points.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    mu = torch.sum(points * w[..., None], dim=-2)
    c = (points - mu[..., None, :]) * torch.sqrt(w)[..., None]
    n = torch.linalg.svd(c, full_matrices=False)[2][..., 2, :]
    d = -torch.sum(n * mu, dim=-1)
    return torch.cat([n, d[..., None]], dim=-1)


def fit_line(points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Least-squares 3-D line (origin, direction) (ref: Geometry.cpp:222-262
    `FitLine`): the mean, and the largest principal axis (its sign the SVD's)."""
    mu = torch.mean(points, dim=-2)
    return mu, torch.linalg.svd(points - mu[..., None, :], full_matrices=False)[2][..., 0, :]


def plane_point_distance(plane: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Signed distances: plane (..., 4), points (..., N, 3) -> (..., N)."""
    return torch.einsum("...i,...ni->...n", plane[..., :3], points) + plane[..., 3:4]


def estimate_normals_from_neighbors(neighbors: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-point unit normal from its K gathered neighbours: the eigenvector
    of the smallest eigenvalue of their covariance.
    neighbors (..., N, K, 3), valid (..., N, K) -> (..., N, 3)."""
    w = valid.to(neighbors.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mu = torch.sum(neighbors * w[..., None], dim=-2) / wsum
    c = (neighbors - mu[..., None, :]) * w[..., None]
    cov = torch.einsum("...ki,...kj->...ij", c, c)
    _, evecs = torch.linalg.eigh(cov)
    n = evecs[..., :, 0]
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
