"""RANSAC with all hypotheses at once: rigid 3D-3D alignment, planes, the
pairwise-consistency filter (RanSaPC) and the homography filter of pixel
matches.

Port of `onepiece_tpu/ops/ransac.py` (`_sample_indices`, `ransac_rigid`,
`ransac_plane`, `ransapc_filter`, `homography_filter`). Every hypothesis is drawn up front (Gumbel top-k from an
explicit `torch.Generator`), scored with one batched transform and the best
one is refit; nothing depends on the data to decide what runs next.

Sampling is split from scoring: `sample_indices` draws, and the scoring
functions take `samples=` to use given indices instead (the tests feed the
JAX package's draws in: the two RNGs give different numbers).

`ransac_rigid` draws in PyTorch on every device. From the draw to the best
hypothesis it launches the hand-written CUDA kernel (`csrc/ransac_rigid.cu`)
on CUDA tensors and runs its plain version, the PyTorch code below, on CPU
tensors. The refit of the best hypothesis is the same PyTorch code on both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..geometry import transforms
from ..utils import tracing

RANSAPC_ANCHORS = 8  # anchors a correspondence is checked against
RANSAPC_MIN_VOTES = 5  # consistent anchors a correspondence needs
RANSAPC_TOLERANCE = 0.1  # m: the largest change of a pairwise distance


class RansacResult(NamedTuple):
    T: torch.Tensor  # (4, 4) best rigid transform
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int64
    rmse: torch.Tensor  # () inlier rmse


class BestHypothesis(NamedTuple):
    T: torch.Tensor  # (4, 4) the first hypothesis with the most inliers
    inliers: torch.Tensor  # (N,) bool
    count: torch.Tensor  # () int64
    d2: torch.Tensor  # (N,) its squared residuals
    gate: torch.Tensor | float  # (N,) or (): the squared gate


def sample_indices(
    generator: torch.Generator, valid: torch.Tensor, num_hyp: int, sample_size: int
) -> torch.Tensor:
    """(H, S) int64 indices of valid entries, without replacement within a
    hypothesis: the top S of Gumbel noise, with invalid entries at -inf."""
    u = torch.rand((num_hyp, valid.shape[0]), generator=generator, device=valid.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    logits = torch.where(valid, 0.0, -torch.inf)
    return torch.topk(logits[None, :] + g, sample_size, dim=-1).indices


def ransac_rigid(
    generator: torch.Generator | None,
    src: torch.Tensor,  # (N, 3)
    dst: torch.Tensor,  # (N, 3)
    valid: torch.Tensor,  # (N,) bool
    threshold: float,
    num_hypotheses: int,
    sample_size: int,
    samples: torch.Tensor | None = None,  # (H, S) indices instead of drawing
    norm_z: torch.Tensor | None = None,  # (N,) depths: a depth-normalised gate
) -> RansacResult:
    """Rigid RANSAC: a quaternion-Kabsch fit per sampled hypothesis, inliers
    within `threshold`, the best hypothesis refit on its inliers with the
    SVD Kabsch (kept only if it loses no inliers).

    With `norm_z` (per-correspondence depths) the gate is the reference's
    depth-normalised error ||T p - q|| / z <= threshold, and the rmse is
    reported in the same normalised units. Its stages are spans of the
    caller's layer: `.hypotheses`, then `.fit` (the kernel) on the card or
    `.score` on the CPU, then `.refit`."""
    with tracing.span(".hypotheses"):
        if samples is None:
            samples = sample_indices(generator, valid, num_hypotheses, sample_size)
        if not src.is_cuda:
            Ts = transforms.kabsch_fast(src[samples], dst[samples])  # (H, 4, 4)
    if src.is_cuda:
        with tracing.span(".fit"):
            best = _best_cuda(src, dst, valid, samples, threshold, norm_z)[0]
    else:
        with tracing.span(".score"):
            best = _best(src, dst, valid, threshold, Ts, norm_z)
    with tracing.span(".refit"):
        return _refit(src, dst, valid, best, norm_z)


def ransac_rigid_reference(src, dst, valid, threshold: float, samples, norm_z=None) -> RansacResult:
    """The plain route after the draw, on any device (the card tests and
    `chip_smoke.py` hold the kernel route to it on the card)."""
    best = _best(src, dst, valid, threshold, transforms.kabsch_fast(src[samples], dst[samples]), norm_z)
    return _refit(src, dst, valid, best, norm_z)


def _thr2(threshold: float) -> float:
    """The fixed gate, squared in float32 as the JAX package squares its
    traced threshold."""
    return float(np.float32(threshold) * np.float32(threshold))


def _best(src, dst, valid, threshold, Ts, norm_z) -> BestHypothesis:
    """The plain version of the kernel: hypotheses Ts (H, 4, 4) scored, the
    first with the most inliers."""
    thr2 = _thr2(threshold) if norm_z is None else torch.square(threshold * norm_z)
    pred = torch.einsum("hij,nj->hni", Ts[:, :3, :3], src) + Ts[:, None, :3, 3]
    d2 = torch.sum((pred - dst[None]) ** 2, dim=-1)  # (H, N)
    inl = (d2 < thr2) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts).reshape(1)

    def at_best(t):  # t[best] by index_select: indexing with a device scalar would read it on the host
        return t.index_select(0, best)[0]

    return BestHypothesis(at_best(Ts), at_best(inl), at_best(counts), at_best(d2), thr2)


def _refit(src, dst, valid, best: BestHypothesis, norm_z) -> RansacResult:
    """The SVD Kabsch over the best's inliers, kept where it loses none."""
    T_refit = transforms.kabsch(src, dst, best.inliers.to(torch.float32))
    d2_r = torch.sum((src @ T_refit[:3, :3].T + T_refit[:3, 3] - dst) ** 2, dim=-1)
    inl_r = (d2_r < best.gate) & valid
    better = torch.sum(inl_r) >= best.count
    T_out = torch.where(better, T_refit, best.T)
    inl_out = torch.where(better, inl_r, best.inliers)
    nin = torch.sum(inl_out)
    d2_out = torch.where(better, d2_r, best.d2)
    if norm_z is not None:
        d2_out = d2_out / torch.clamp(torch.square(norm_z), min=1e-6)
    rmse = torch.sqrt(
        torch.sum(torch.where(inl_out, d2_out, 0.0)) / torch.clamp(nin.to(torch.float32), min=1.0)
    )
    return RansacResult(T_out, inl_out, nin, rmse)


_COUNTERS: dict = {}  # a zeroed ticket counter a device; the kernel leaves it at 0


def _best_cuda(src, dst, valid, samples, threshold: float, norm_z):
    """One launch of `csrc/ransac_rigid.cu`: (BestHypothesis, the hypotheses'
    (H, 12) R row-major and t, their (H + 1,) inlier counts followed by the
    best's index). The depths may be a strided view (`src[:, 2]`)."""
    dev, n = src.device, src.shape[0]
    src, dst, samples = src.contiguous(), dst.contiguous(), samples.to(torch.int64).contiguous()
    _build.require(src, "src", torch.float32, (n, 3), dev)
    _build.require(dst, "dst", torch.float32, (n, 3), dev)
    _build.require(valid, "valid", torch.bool, (n,), dev)
    _build.require(samples, "samples", torch.int64, (None, None), dev)
    if norm_z is not None and (norm_z.device != dev or norm_z.dtype != torch.float32 or norm_z.shape != (n,)):
        raise ValueError(f"norm_z: {norm_z.dtype} {tuple(norm_z.shape)} on {norm_z.device}, expected float32 "
                         f"({n},) on {dev}")
    h, s = samples.shape
    if n < 1 or h < 1 or s < 1:
        raise ValueError(f"ransac_rigid: {n} correspondences, samples {(h, s)}: none may be empty")
    if dev not in _COUNTERS:
        _COUNTERS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    hyp_T = torch.empty((h, 12), dtype=torch.float32, device=dev)
    hyp_count = torch.empty(h + 1, dtype=torch.int32, device=dev)
    best = BestHypothesis(
        torch.empty((4, 4), dtype=torch.float32, device=dev), torch.empty(n, dtype=torch.bool, device=dev),
        torch.empty((), dtype=torch.int64, device=dev), torch.empty(n, dtype=torch.float32, device=dev),
        torch.empty(n, dtype=torch.float32, device=dev))
    err = _build.library().ransac_rigid(
        src.data_ptr(), dst.data_ptr(), valid.data_ptr(), 0 if norm_z is None else norm_z.data_ptr(),
        0 if norm_z is None else norm_z.stride(0), n, samples.data_ptr(), h, s, threshold, _thr2(threshold),
        max(1, (transforms.POWER_ITERS + 3) // 4), hyp_T.data_ptr(), hyp_count.data_ptr(),
        _COUNTERS[dev].data_ptr(), *(t.data_ptr() for t in best), _build.stream_handle(src),
    )
    _build.check(err, _build.RANSAC_RIGID)
    _build.RANSAC_RIGID.launches += 1
    tracing.count("ransac.kernel")
    return best, hyp_T, hyp_count


def ransapc_filter(
    generator: torch.Generator | None,
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    tolerance: float = RANSAPC_TOLERANCE,
    samples: torch.Tensor | None = None,  # (A,) anchor indices instead of drawing
) -> torch.Tensor:
    """Pairwise-consistency filter: rigid motion keeps distances, so a
    correspondence votes for an anchor when | |src_i - src_a| - |dst_i -
    dst_a| | < tolerance. Returns the mask of valid correspondences with at
    least RANSAPC_MIN_VOTES votes from valid anchors."""
    if samples is None:
        samples = sample_indices(generator, valid, 1, RANSAPC_ANCHORS)[0]
    ds = torch.linalg.norm(src[:, None, :] - src[samples][None], dim=-1)  # (N, A)
    dd = torch.linalg.norm(dst[:, None, :] - dst[samples][None], dim=-1)
    consistent = torch.abs(ds - dd) < tolerance
    votes = torch.sum(consistent & valid[samples][None, :], dim=-1)
    return valid & (votes >= RANSAPC_MIN_VOTES)


def ransac_plane(
    generator: torch.Generator | None,
    points: torch.Tensor,  # (N, 3)
    valid: torch.Tensor,  # (N,) bool
    threshold: float = 0.02,
    num_hypotheses: int = 256,
    samples: torch.Tensor | None = None,  # (H, 3) indices instead of drawing
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plane RANSAC (ref: Ransac.cpp:42-77 `FitPlaneRANSAC`): a plane through
    each sampled triple, the one with most points within `threshold` refit
    on its inliers. Returns (plane (4,) [n | d], inlier mask (N,))."""
    if samples is None:
        samples = sample_indices(generator, valid, num_hypotheses, 3)
    planes = transforms.fit_plane(points[samples])  # (H, 4)
    d = torch.abs(torch.einsum("hi,ni->hn", planes[:, :3], points) + planes[:, 3:4])
    inl = (d < threshold) & valid[None, :]
    best = torch.argmax(torch.sum(inl, dim=-1)).reshape(1)
    plane = transforms.fit_plane(points, inl.index_select(0, best)[0].to(points.dtype))
    return plane, (torch.abs(points @ plane[:3] + plane[3]) < threshold) & valid


def homography_filter(
    generator: torch.Generator | None,
    uv_src: torch.Tensor,  # (N, 2) source pixels
    uv_dst: torch.Tensor,  # (N, 2) matched target pixels
    valid: torch.Tensor,  # (N,) bool
    threshold: float = 6.0,
    num_hypotheses: int = 256,
    samples: torch.Tensor | None = None,  # (H, 4) indices instead of drawing
) -> torch.Tensor:
    """Homography-RANSAC filter of pixel matches (ref:
    SparseOdometryFunction.h:102-127 `OutlierFilter::Ransac`,
    cv::findHomography with the 6 px REPROJECTION_ERROR_2D_THRESHOLD).

    The points are normalised by the valid points' centroid and mean
    distance; each 4-point hypothesis is the null vector of its 8x9 DLT
    system (the smallest eigenvector of A^T A, batched); a match is an
    inlier when its transfer error, back in pixels, is below `threshold`.
    Returns the best hypothesis' inlier mask, or the input mask when no
    hypothesis keeps max(4, valid / 4) matches (where findHomography fails
    and the reference keeps the matches unfiltered)."""
    vw = valid.to(torch.float32)
    n_valid = torch.clamp(torch.sum(vw), min=1.0)
    center = torch.sum(torch.cat([uv_src, uv_dst], 0) * torch.cat([vw, vw])[:, None], dim=0) / (2.0 * n_valid)
    mean_dist = torch.sum((torch.linalg.vector_norm(uv_src - center, dim=-1)
                           + torch.linalg.vector_norm(uv_dst - center, dim=-1)) * vw) / (2.0 * n_valid)
    scale = 1.0 / torch.clamp(mean_dist, min=1e-6)
    s_n = (uv_src - center) * scale
    d_n = (uv_dst - center) * scale
    if samples is None:
        samples = sample_indices(generator, valid, num_hypotheses, 4)
    x, y = s_n[samples, 0], s_n[samples, 1]  # (H, 4)
    u, v = d_n[samples, 0], d_n[samples, 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    A = torch.cat([r1, r2], dim=1)  # (H, 8, 9)
    Hs = torch.linalg.eigh(A.transpose(-1, -2) @ A)[1][..., :, 0].reshape(-1, 3, 3)
    src_h = torch.cat([s_n, torch.ones_like(s_n[:, :1])], dim=-1)  # (N, 3)
    proj = torch.einsum("hij,nj->hni", Hs, src_h)
    wz = torch.where(torch.abs(proj[..., 2]) > 1e-8, proj[..., 2], 1e-8)
    err = torch.linalg.vector_norm(proj[..., :2] / wz[..., None] - d_n[None], dim=-1) / scale
    inl = (err < threshold) & valid[None]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts).reshape(1)
    ok = counts.index_select(0, best)[0] >= torch.clamp(torch.sum(valid) // 4, min=4)
    return torch.where(ok, inl.index_select(0, best)[0], valid)
