"""Plain PyTorch operations of DenseSlam's submap registration, frozen.

Copies of the port's plain (CPU-path) versions, in their operation order:
the brute-force k-NN (`ops/knn.py`), the plain 1-NN of ICP
(`ops/nn1.nn1_reference`, which the nn1 kernel matches bit for bit), the
point-cloud steps of a submap (`geometry/pointcloud.py`: `from_rgbd`,
`transform`, `merge`, `voxel_downsample`, `compact`, `estimate_normals`),
FPFH (`registration/fpfh.py`), point-to-point ICP (`registration/icp.py`)
and global registration (`registration/global_reg.py`: feature match,
RanSaPC, rigid RANSAC). RANSAC, Kabsch and the SE(3) helpers are the
frozen copies of `fba/`. They run on any device and launch no kernel of
the program; the draws come from a generator seeded 0 on the points'
device, anew for each registration, as the program's do.

`rnd` is the precision of the control (`plain_ops.bf16`): applied where a
stage stores points, normals or descriptors; sums stay float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .fba.geometry import se3, transforms
from .fba.ops import ransac
from .plain_ops import exact

EIGH_BATCH = 16384
KEY_PAD = torch.iinfo(torch.int32).max
LARGE = 1e30
TILE = 2048
MIN_INLIERS = 30  # RANSAC inliers for a successful registration
NUM_BINS = 11


class Cloud(NamedTuple):
    """A fixed-capacity cloud: (C, 3) points, normals, colours; (C,) valid."""

    points: torch.Tensor
    normals: torch.Tensor
    colors: torch.Tensor
    valid: torch.Tensor


class Features(NamedTuple):
    points: torch.Tensor
    normals: torch.Tensor
    valid: torch.Tensor
    fpfh: torch.Tensor  # (N, 33)


class Registration(NamedTuple):
    T: torch.Tensor
    num_inliers: torch.Tensor
    success: torch.Tensor


# --- k-NN ----------------------------------------------------------------------


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    x64 = x.to(torch.float64)
    t = (x64[..., 0] * x64[..., 0]).to(torch.float32)
    for i in range(1, x.shape[-1]):
        t = (x64[..., i] * x64[..., i] + t).to(torch.float32)
    return t


def knn(query, ref, ref_valid, k: int = 1):
    """Exact k-NN by |a|^2 + |b|^2 - 2 a.b: (indices (N, k), squared distances)."""
    idx_out, d_out = [], []
    for q in torch.split(query, TILE):
        cross = q @ ref.T
        d = torch.clamp(_sqnorm(q)[:, None] + _sqnorm(ref)[None, :] - 2.0 * cross, min=0.0)
        d = torch.where(ref_valid[None, :], d, LARGE)
        if k == 1:
            idx = torch.argmin(d, dim=-1, keepdim=True)
            dist = torch.gather(d, 1, idx)
        else:
            dist, idx = torch.topk(d, k, dim=-1, largest=False)
        idx_out.append(idx)
        d_out.append(dist)
    return torch.cat(idx_out), torch.cat(d_out)


def nn1(query, ref, ref_valid):
    """ICP's 1-NN: (idx (N,) int32, d2 (N,)), d2 = (dx*dx + dy*dy) + dz*dz."""
    n = query.shape[0]
    idx = torch.zeros(n, dtype=torch.int32, device=query.device)
    d2 = torch.full((n,), LARGE, dtype=torch.float32, device=query.device)
    if ref.shape[0] == 0:
        return idx, d2
    for s in range(0, n, TILE):
        q = query[s : s + TILE]
        d = q[:, None, 0] - ref[None, :, 0]
        d.mul_(d)
        dy = q[:, None, 1] - ref[None, :, 1]
        d.add_(dy.mul_(dy))
        dz = torch.sub(q[:, None, 2], ref[None, :, 2], out=dy)
        d.add_(dz.mul_(dz))
        d.nan_to_num_(nan=torch.inf).masked_fill_(~ref_valid[None, :], torch.inf)
        arg = torch.argmin(d, dim=1)
        best = torch.gather(d, 1, arg[:, None])[:, 0]
        found = best < LARGE
        idx[s : s + TILE] = torch.where(found, arg, 0).to(torch.int32)
        d2[s : s + TILE] = torch.where(found, best, LARGE)
    return idx, d2


# --- a submap's cloud ------------------------------------------------------------


def _next_capacity(n: int) -> int:
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


def frame_cloud(depth, camera, T, depth_min: float, depth_max: float, rnd=exact) -> Cloud:
    """A depth image back-projected (black, zero normals) and moved by T."""
    pts = camera.backproject_grid(depth).reshape(-1, 3)
    valid = ((depth > depth_min) & (depth < depth_max) & torch.isfinite(depth)).reshape(-1)
    zeros = torch.zeros_like(pts)
    return Cloud(rnd(se3.transform_points(T, pts)), se3.transform_normals(T, zeros), zeros, valid)


def merge(*clouds: Cloud) -> Cloud:
    return Cloud(*(torch.cat([c[i] for c in clouds]) for i in range(4)))


def voxel_downsample(cloud: Cloud, voxel_size: float) -> Cloud:
    """One averaged point, normal and colour per occupied voxel, in key order."""
    cap, dev = cloud.points.shape[0], cloud.points.device
    off = torch.clamp(torch.floor(cloud.points / voxel_size).to(torch.int32) + 512, 0, 1023)
    key = torch.where(cloud.valid, (off[:, 0] << 20) | (off[:, 1] << 10) | off[:, 2], KEY_PAD)
    key_s, order = torch.sort(key, stable=True)
    seg_start = torch.ones_like(key_s, dtype=torch.bool)
    seg_start[1:] = key_s[1:] != key_s[:-1]
    seg_id = (torch.cumsum(seg_start.to(torch.int32), 0) - 1).to(torch.int64)
    lengths = torch.zeros(cap, dtype=torch.int64, device=dev).index_add_(0, seg_id, torch.ones_like(seg_id))
    cnt = torch.clamp(lengths[:, None].to(torch.float32), min=1.0)
    fields = torch.cat([cloud.points, cloud.normals, cloud.colors], 1)[order]
    sums = torch.segment_reduce(fields, "sum", lengths=lengths, axis=0, unsafe=True)
    new_pts, new_nrm, new_col = (x.contiguous() for x in (sums / cnt).split(3, 1))
    nnorm = torch.linalg.norm(new_nrm, dim=-1, keepdim=True)
    new_nrm = torch.where(nnorm > 1e-9, new_nrm / torch.clamp(nnorm, min=1e-9), new_nrm)
    num_segs = torch.sum(seg_start & (key_s < KEY_PAD))
    return Cloud(new_pts, new_nrm, new_col, torch.arange(cap, device=dev) < num_segs)


def compact(cloud: Cloud) -> Cloud:
    """The valid points at the front of a cloud of the next capacity."""
    keep = torch.nonzero(cloud.valid)[:, 0]
    n = keep.shape[0]
    cap = _next_capacity(n)
    fields = []
    for x in cloud[:3]:
        out = torch.zeros((cap, 3), dtype=torch.float32, device=x.device)
        out[:n] = x[keep]
        fields.append(out)
    return Cloud(*fields, torch.arange(cap, device=cloud.points.device) < n)


# --- features ------------------------------------------------------------------------


def normals_from_neighbors(neighbors, valid):
    """The smallest covariance eigenvector of each point's K neighbours, the
    eigenproblems solved EIGH_BATCH at a time."""
    w = valid.to(neighbors.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mu = torch.sum(neighbors * w[..., None], dim=-2) / wsum
    c = (neighbors - mu[..., None, :]) * w[..., None]
    cov = torch.einsum("...ki,...kj->...ij", c, c)
    flat = cov.reshape(-1, 3, 3)
    evecs = torch.cat([torch.linalg.eigh(part)[1] for part in flat.split(EIGH_BATCH)]).reshape(cov.shape)
    n = evecs[..., :, 0]
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)


def estimate_normals(cloud: Cloud, k: int) -> torch.Tensor:
    idx = knn(cloud.points, cloud.points, cloud.valid, k=k)[0]
    normals = normals_from_neighbors(cloud.points[idx], cloud.valid[idx])
    flip = torch.sum(normals * cloud.points, dim=-1) > 0.0
    normals = torch.where(flip[:, None], -normals, normals)
    return torch.where(cloud.valid[:, None], normals, 0.0)


def _pair_features(p1, n1, p2, n2):
    d = p2 - p1
    dist = torch.linalg.norm(d, dim=-1)
    du = d / torch.where(dist > 1e-9, dist, 1.0)[..., None]
    a1 = torch.abs(torch.sum(n1 * du, dim=-1))
    a2 = torch.abs(torch.sum(n2 * du, dim=-1))
    swap = (a2 > a1)[..., None]
    ns = torch.where(swap, n2, n1)
    nt = torch.where(swap, n1, n2)
    du = torch.where(swap, -du, du)
    u = ns
    v = torch.linalg.cross(du, u)
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    v = v / torch.where(vn > 1e-9, vn, 1.0)
    w = torch.linalg.cross(u, v)
    alpha = torch.sum(v * nt, dim=-1)
    phi = torch.sum(u * du, dim=-1)
    theta = torch.atan2(torch.sum(w * nt, dim=-1), torch.sum(u * nt, dim=-1))
    return alpha, phi, theta


def _histogram(vals, lo: float, hi: float, w):
    b = torch.clamp(((vals - lo) / (hi - lo) * NUM_BINS).to(torch.int64), 0, NUM_BINS - 1)
    out = torch.zeros((vals.shape[0], NUM_BINS), dtype=torch.float32, device=vals.device)
    return out.scatter_add_(1, b, w)


def fpfh(points, normals, valid, radius: float, k: int):
    """(N, 33) FPFH descriptors; invalid points get zeros."""
    idx, d2 = knn(points, points, valid, k=k)
    in_r = d2 <= radius * radius
    nb_ok = in_r & (d2 > 1e-12) & valid[:, None] & valid[idx]
    w = nb_ok.to(torch.float32)
    alpha, phi, theta = _pair_features(points[:, None, :], normals[:, None, :], points[idx], normals[idx])
    spfh = torch.cat([_histogram(alpha, -1.0, 1.0, w), _histogram(phi, -1.0, 1.0, w),
                      _histogram(theta, -math.pi, math.pi, w)], dim=-1)
    spfh = spfh / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    inv_d = torch.where(nb_ok, 1.0 / torch.sqrt(torch.clamp(d2, min=1e-12)), 0.0)
    agg = torch.einsum("nkf,nk->nf", spfh[idx], inv_d)
    ksum = torch.clamp(torch.sum(nb_ok, dim=-1, keepdim=True).to(torch.float32), min=1.0)
    out = spfh + agg / ksum
    blocks = out.reshape(-1, 3, NUM_BINS)
    s = torch.clamp(torch.sum(blocks, dim=-1, keepdim=True), min=1e-9)
    out = (blocks / s * 100.0).reshape(-1, 3 * NUM_BINS)
    return torch.where(valid[:, None], out, 0.0)


def extract_features(cloud: Cloud, cfg: dict, rnd=exact) -> Features:
    """Normals and FPFH of a downsampled submap cloud."""
    normals = rnd(estimate_normals(cloud, cfg["normal_k"]))
    return Features(cloud.points, normals, cloud.valid,
                    rnd(fpfh(cloud.points, normals, cloud.valid, cfg["fpfh_radius"], cfg["fpfh_k"])))


# --- ICP and global registration ---------------------------------------------------


def icp(src, src_valid, tgt, tgt_valid, init_T, threshold: float, iters: int):
    """Point-to-point ICP: (T, inliers, rmse) after `iters` Kabsch steps."""
    T = init_T.to(device=src.device, dtype=torch.float32)

    def correspond(T):
        idx, d2 = nn1(src @ T[:3, :3].T + T[:3, 3], tgt, tgt_valid)
        return idx.long(), d2, src_valid & (d2 < threshold * threshold)

    for _ in range(iters):
        idx, _, ok = correspond(T)
        w = ok.to(torch.float32)
        T_new = transforms.kabsch(src, tgt[idx], w)
        good = torch.isfinite(T_new).all() & (torch.sum(w) > 3)
        T = torch.where(good, T_new, T)
    _, d2, ok = correspond(T)
    n = torch.sum(ok)
    rmse = torch.sqrt(torch.sum(torch.where(ok, d2, 0.0)) / torch.clamp(n, min=1))
    return T, n, rmse


def register(src: Features, tgt: Features, cfg: dict) -> Registration:
    """T mapping src onto tgt: 1-NN of the descriptors, RanSaPC, rigid RANSAC."""
    generator = torch.Generator(device=src.points.device).manual_seed(0)
    idx = knn(src.fpfh, tgt.fpfh, tgt.valid, k=1)[0][:, 0]
    ok = src.valid & tgt.valid[idx]
    dst_pts = tgt.points[idx]
    for _ in range(cfg["ransapc_rounds"]):
        ok = ransac.ransapc_filter(generator, src.points, dst_pts, ok, tolerance=cfg["voxel_size"] * 3.0)
    res = ransac.ransac_rigid(generator, src.points, dst_pts, ok, threshold=cfg["ransac_threshold"],
                              num_hypotheses=cfg["num_hypotheses"], sample_size=cfg["sample_size"])
    return Registration(res.T, res.num_inliers, res.num_inliers >= MIN_INLIERS)
