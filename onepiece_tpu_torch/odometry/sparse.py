"""Sparse feature-based RGB-D odometry.

Port of `onepiece_tpu/odometry/sparse.py` (`SparseFrame`,
`SparseTrackingResult`, `TrackingSummary`, `ChunkScanOut`,
`extract_sparse_frame`, `extract_sparse_frames_batch`,
`_match_and_estimate`, `sparse_tracking`, `sparse_tracking_with_summary`,
`_track_summary_inner`, `sparse_chunk_scan`, `track_pairs_batch`,
`se3_inverse`): FAST/BRIEF features backprojected
with the depth, descriptor matching with the ratio test, five RanSaPC
pairwise-consistency rounds, depth-normalised RANSAC, then a pose-guided
windowed re-match and a second RANSAC; the round with more inliers wins.

Randomness comes from an explicit `torch.Generator`; `draws=` hands in the
anchors and hypotheses instead (the tests feed the JAX package's). The JAX
package gates the second round behind a `lax.cond` on `rematch_below`; here
both rounds always run and the gate selects with `torch.where`, so no host
read is needed, and where the gate skips round 2 its result is round 1's,
exactly as the cond returns it. The chunk scan and the pair batch, one
`lax.scan` and one `lax.map` program there, are Python loops over device
tensors here that read nothing on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import PinholeCamera
from ..ops import hamming, ransac
from . import features as feat

# reference thresholds (ref: src/Odometry/Odometry.cpp SparseTrackingMILD and
# SparseOdometryFunction.cpp RANSAC3d)
RANSAC_THRESHOLD = 0.01  # depth-normalised: ||Tp - q|| / z
RANSAC_HYPOTHESES = 400
RANSAC_SAMPLES = 8
RANSAPC_ROUNDS = 5  # ref: Odometry.cpp:400-404 applies RanSaPC 5x
MIN_INLIERS = 20


class SparseFrame(NamedTuple):
    """Per-frame sparse data: keypoints + backprojected 3D points (leaves may
    carry leading batch axes)."""

    kp: feat.Keypoints
    points: torch.Tensor  # (K, 3) camera-frame 3D points at keypoints
    valid: torch.Tensor  # (K,) keypoint has valid depth


class SparseTrackingResult(NamedTuple):
    T_ts: torch.Tensor  # (4, 4) source -> target
    num_inliers: torch.Tensor  # () int64
    rmse: torch.Tensor
    success: torch.Tensor  # () bool
    corr_src: torch.Tensor  # (K, 3) source points
    corr_dst: torch.Tensor  # (K, 3) matched target points
    corr_valid: torch.Tensor  # (K,)
    corr_idx: torch.Tensor  # (K,) matched TARGET keypoint index per source kp


class TrackingSummary(NamedTuple):
    """Scalars of a track: what the keyframe decision reads."""

    T_ts: torch.Tensor  # (4, 4)
    success: torch.Tensor  # () bool
    rmse: torch.Tensor
    num_inliers: torch.Tensor
    disparity: torch.Tensor  # () average pixel disparity over inlier matches


class ChunkScanOut(NamedTuple):
    """Per-frame outputs of the keyframe-selection scan (leading K axis)."""

    T_world: torch.Tensor  # (K, 4, 4)
    is_kf: torch.Tensor  # (K,) bool
    success: torch.Tensor  # (K,) bool
    rmse: torch.Tensor  # (K,)
    disparity: torch.Tensor  # (K,)
    corr_src: torch.Tensor  # (K, N, 3) against the frame's tracking keyframe
    corr_dst: torch.Tensor  # (K, N, 3)
    corr_valid: torch.Tensor  # (K, N)
    corr_idx: torch.Tensor  # (K, N) matched keypoint index in the frame
    promote_prev: torch.Tensor  # (K,) bool: frame i-1 promoted when frame i lost tracking


class Draws(NamedTuple):
    """Given random draws for `_match_and_estimate`."""

    anchors: torch.Tensor  # (RANSAPC_ROUNDS, 8) RanSaPC anchors per round
    round1: torch.Tensor  # (H, RANSAC_SAMPLES) hypotheses of the first RANSAC
    round2: torch.Tensor  # (H, RANSAC_SAMPLES) hypotheses of the second


def map_frame(fn, frame: SparseFrame) -> SparseFrame:
    """Apply fn to every tensor of a SparseFrame."""
    return SparseFrame(feat.Keypoints(*(fn(t) for t in frame.kp)), fn(frame.points), fn(frame.valid))


def zip_frames(fn, *frames: SparseFrame) -> SparseFrame:
    """fn over the matching tensors of several SparseFrames."""
    kps = [f.kp for f in frames]
    return SparseFrame(
        feat.Keypoints(*(fn(*ts) for ts in zip(*kps))),
        fn(*(f.points for f in frames)), fn(*(f.valid for f in frames)),
    )


def extract_sparse_frames_batch(
    grays: torch.Tensor,  # (B, H, W)
    depths: torch.Tensor,  # (B, H, W)
    camera: PinholeCamera,
    max_keypoints: int = 1000,
    threshold: float = 0.05,
) -> SparseFrame:
    """Detect and describe features over a chunk and backproject them with
    the depth at their (rounded, clipped) pixels."""
    b, h, w = grays.shape
    kp = feat.detect_and_describe_batch(grays, max_keypoints=max_keypoints, threshold=threshold)
    ui = torch.clamp(torch.round(kp.uv[..., 0]), 0, w - 1).to(torch.int64)
    vi = torch.clamp(torch.round(kp.uv[..., 1]), 0, h - 1).to(torch.int64)
    z = torch.gather(depths.reshape(b, h * w), 1, vi * w + ui)
    pts = camera.backproject(kp.uv, z)
    return SparseFrame(kp, pts, kp.valid & (z > 0))


def extract_sparse_frame(gray, depth, camera: PinholeCamera, max_keypoints: int = 1000,
                         threshold: float = 0.05) -> SparseFrame:
    """One frame of `extract_sparse_frames_batch`."""
    f = extract_sparse_frames_batch(gray[None], depth[None], camera, max_keypoints, threshold)
    return map_frame(lambda t: t[0], f)


def _ransac(generator, src, dst, ok, num_hypotheses, samples):
    return ransac.ransac_rigid(
        generator, src, dst, ok, threshold=RANSAC_THRESHOLD, num_hypotheses=num_hypotheses,
        sample_size=RANSAC_SAMPLES, samples=samples, norm_z=src[:, 2],
    )


def _match_and_estimate(
    generator: torch.Generator | None,
    source: SparseFrame,
    target: SparseFrame,
    camera: PinholeCamera,
    num_hypotheses: int = RANSAC_HYPOTHESES,
    rematch_below: int | None = None,
    draws: Draws | None = None,
) -> SparseTrackingResult:
    """Estimate T_ts mapping source-frame points onto the target frame's."""
    # round 1: descriptor match + ratio test
    idx, ok = hamming.match_descriptors(source.kp.desc, source.valid, target.kp.desc, target.valid)
    src_pts = source.points
    dst_pts = target.points[idx]
    ok = ok & target.valid[idx]
    for r in range(RANSAPC_ROUNDS):
        ok = ransac.ransapc_filter(generator, src_pts, dst_pts, ok,
                                   samples=None if draws is None else draws.anchors[r])
    res1 = _ransac(generator, src_pts, dst_pts, ok, num_hypotheses, None if draws is None else draws.round1)

    # round 2: pose-guided re-match (ref: SparseMatcher.cpp:25-50)
    pred = src_pts @ res1.T[:3, :3].T + res1.T[:3, 3]
    uv_pred, _ = camera.project(pred)
    idx2, ok2 = hamming.match_descriptors_windowed(
        source.kp.desc, source.valid, target.kp.desc, target.valid, uv_pred, target.kp.uv,
    )
    dst2 = target.points[idx2]
    ok2 = ok2 & target.valid[idx2]
    res2 = _ransac(generator, src_pts, dst2, ok2, num_hypotheses, None if draws is None else draws.round2)
    if rematch_below is not None:
        # the JAX package's cond: below the gate round 2 runs, else it is round 1
        run2 = res1.num_inliers < rematch_below
        res2 = ransac.RansacResult(*(torch.where(run2, a, b) for a, b in zip(res2, res1)))
        dst2 = torch.where(run2, dst2, dst_pts)
        idx2 = torch.where(run2, idx2, idx)

    use2 = res2.num_inliers >= res1.num_inliers
    nin = torch.where(use2, res2.num_inliers, res1.num_inliers)
    return SparseTrackingResult(
        torch.where(use2, res2.T, res1.T), nin, torch.where(use2, res2.rmse, res1.rmse),
        nin >= MIN_INLIERS, src_pts, torch.where(use2, dst2, dst_pts),
        torch.where(use2, res2.inliers, res1.inliers), torch.where(use2, idx2, idx),
    )


def sparse_tracking(
    source: SparseFrame,
    target: SparseFrame,
    camera: PinholeCamera,
    generator: torch.Generator | None = None,
) -> SparseTrackingResult:
    """Estimate T_ts mapping source-frame points into the target frame
    (the reference's convention: RANSAC over matched 3-D pairs). Random
    draws come from `generator`, or from a generator seeded 0 on the
    frames' device."""
    if generator is None:
        generator = torch.Generator(device=source.points.device).manual_seed(0)
    return _match_and_estimate(generator, source, target, camera)


def _track_summary_inner(
    generator, source, target, camera, num_hypotheses=RANSAC_HYPOTHESES, rematch_below=None, draws=None,
) -> tuple[SparseTrackingResult, TrackingSummary]:
    """`_match_and_estimate` and its summary, with the reference's average
    pixel disparity over the inlier matches (ref: Correspondence.h:22-40)."""
    res = _match_and_estimate(generator, source, target, camera, num_hypotheses, rematch_below, draws)
    uv_dst, _ = camera.project(res.corr_dst)
    d = torch.linalg.norm(uv_dst - source.kp.uv, dim=-1)
    vf = res.corr_valid.to(torch.float32)
    disp = torch.sum(d * vf) / torch.clamp(torch.sum(vf), min=1.0)
    return res, TrackingSummary(res.T_ts, res.success, res.rmse, res.num_inliers, disp)


def sparse_tracking_with_summary(
    source: SparseFrame,
    target: SparseFrame,
    camera: PinholeCamera,
    generator: torch.Generator | None = None,
    draws: Draws | None = None,
) -> tuple[SparseTrackingResult, TrackingSummary]:
    """`sparse_tracking` and its scalar summary, both left on the device.
    Draws come from `draws`, else from `generator`, else from a generator
    seeded 0 on the frames' device."""
    if generator is None and draws is None:
        generator = torch.Generator(device=source.points.device).manual_seed(0)
    return _track_summary_inner(generator, source, target, camera, draws=draws)


def sparse_chunk_scan(
    kf_frame: SparseFrame,  # the current keyframe at chunk entry
    kf_pose: torch.Tensor,  # (4, 4) world-from-keyframe
    frames: SparseFrame,  # leaves with a leading K axis
    camera: PinholeCamera,
    generator: torch.Generator | None,
    keyframe_disparity: float,
    draws: list[Draws] | None = None,  # per frame, instead of the generator's
) -> tuple[tuple[SparseFrame, torch.Tensor], ChunkScanOut]:
    """Track a chunk of frames against the running keyframe and select
    keyframes, with no host read (ref: FBASlam.cpp:5-139).

    The carry is the keyframe (frame and pose), the previous frame and its
    pose: a frame that tracks becomes the keyframe when its inlier
    disparity reaches `keyframe_disparity`, and a frame that loses tracking
    keeps the last pose and promotes the previous frame, if that one
    tracked, so the next frame has a near reference (the reference exits
    there, ref: FBASlam.cpp:124-128). Each promotion selects the carry with
    `torch.where`. Returns ((keyframe, its pose) at the chunk's end, the
    per-frame outputs)."""
    thr = float(keyframe_disparity)
    kf, kfp = kf_frame, kf_pose
    prev_frame, prev_T = map_frame(lambda a: a[0], frames), kf_pose  # unused while prev_ok is false
    prev_ok = torch.zeros((), dtype=torch.bool, device=kf_pose.device)
    last_T = kf_pose
    outs = []
    for i in range(frames.points.shape[0]):
        frame_i = map_frame(lambda a: a[i], frames)
        res, summ = _track_summary_inner(generator, kf, frame_i, camera,
                                         draws=None if draws is None else draws[i])
        ok = summ.success
        promote_prev = ~ok & prev_ok
        kf = zip_frames(lambda a, b: torch.where(promote_prev, a, b), prev_frame, kf)
        kfp = torch.where(promote_prev, prev_T, kfp)
        T_world = torch.where(ok, kfp @ se3_inverse(summ.T_ts), last_T)
        is_kf = ok & (summ.disparity >= thr)
        kf = zip_frames(lambda a, b: torch.where(is_kf, a, b), frame_i, kf)
        kfp = torch.where(is_kf, T_world, kfp)
        prev_frame, prev_T, prev_ok, last_T = frame_i, T_world, ok, T_world
        outs.append((T_world, is_kf, ok, summ.rmse, summ.disparity, res.corr_src, res.corr_dst,
                     res.corr_valid, res.corr_idx, promote_prev))
    return (kf, kfp), ChunkScanOut(*(torch.stack(x) for x in zip(*outs)))


def track_pairs_batch(
    sources: SparseFrame,  # leaves with a leading P axis
    targets: SparseFrame,
    camera: PinholeCamera,
    generators: list[torch.Generator] | None = None,  # one per pair
    draws: list[Draws] | None = None,  # one per pair, instead of the generators'
) -> tuple[SparseTrackingResult, TrackingSummary]:
    """Track P (source, target) pairs, each as `_track_summary_inner`;
    results and summaries stacked along a leading P axis, on the device."""
    outs = []
    for p in range(sources.points.shape[0]):
        outs.append(_track_summary_inner(
            None if generators is None else generators[p], map_frame(lambda a: a[p], sources),
            map_frame(lambda a: a[p], targets), camera, draws=None if draws is None else draws[p]))
    res, summ = zip(*outs)
    return (SparseTrackingResult(*(torch.stack(x) for x in zip(*res))),
            TrackingSummary(*(torch.stack(x) for x in zip(*summ))))


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid (4, 4) transform."""
    R = T[:3, :3]
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ T[:3, 3]
    return out
