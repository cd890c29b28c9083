"""Submap-parallel DenseSlam: one submap per rank.

Port of `onepiece_tpu/parallel/submap.py`. The reference's DenseFusion
groups frames into submaps that are independent until registration
(example/DenseFusion/DenseSlam.h:123, DenseSlam.cpp:38-125); within a
submap only frame-to-frame dense VO runs, and across submaps only the
fused, downsampled clouds meet. So the submaps spread over the ranks:

  stage 1 (each rank)  dense VO over its submap's frames (the exact
                       tracker: the GN kernel on the card), plus the
                       boundary pair from the previous submap's last frame
  stage 2 (replicated) the submap base poses, chained from every rank's
                       last relative pose and boundary step (one
                       `all_gather` of 32 floats a rank)
  stage 3 (each rank)  every CLOUD_STRIDE-th frame's cloud in submap-base
                       coordinates, voxel-downsampled, compacted to a fixed
                       capacity, normals and FPFH
  stage 4 (each rank)  ICP against the previous submap, whose cloud comes
                       by `ring_shift`; FPFH-RANSAC and a refining ICP
                       against every older submap, all clouds from one
                       `all_gather` (ICP runs the nn1 kernel on the card)
  stage 5 (replicated) pose-graph Gauss-Newton over the submap base poses
                       from the gathered edges

`submap_pipeline_serial` runs the same stage functions one after the other
on one device; the sharded pipeline moves only data between them, so the
two agree bit for bit where the device computes each stage the same way
twice (`registration/global_reg.register` seeds its generator with 0 on
each call). A stage decides on the device (`torch.where` on the ICP and
RANSAC gates, as the JAX function's masks do); a rank only skips the loop
slots that its submap index masks anyway.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..geometry.pointcloud import PointCloud, estimate_normals, voxel_downsample
from ..odometry import dense
from ..optimization import posegraph
from ..registration import fpfh as fpfh_mod
from ..registration import global_reg, icp
from .comm import ShardGroup

CLOUD_STRIDE = 3  # ref: DenseSlam.h:19-33 (every 3rd frame fused)
ICP_MIN_INLIERS = 50  # ref: DenseSlam.cpp ICP accept gate
LOOP_MIN_INLIERS = 100  # ref: DenseSlam.cpp refine accept gate
MAX_EDGE_CORRS = 512
POSE_GRAPH_ITERS = 5
VOXEL_SIZE = 0.05  # ref: DenseFusion's submap voxel (m)
ICP_THRESHOLD = 0.1  # ref: DenseFusion's ICP correspondence distance (m)


class SubmapTrack(NamedTuple):
    rel: torch.Tensor  # (F, 4, 4) T_base_frame within the submap (rel[0] = I)
    step: torch.Tensor  # (4, 4) inv(T_ts) of the boundary pair (I for submap 0)
    rmse: torch.Tensor  # (F,)


class SubmapGeometry(NamedTuple):
    points: torch.Tensor  # (C, 3) downsampled cloud in submap-base coords
    normals: torch.Tensor  # (C, 3)
    valid: torch.Tensor  # (C,)
    fpfh: torch.Tensor  # (C, 33)


class SubmapEdges(NamedTuple):
    """Fixed-shape edge buffers of one submap (E = 1 + max_loops slots):
    slot 0 the previous submap, slot 1 + l the older submap l."""

    dst: torch.Tensor  # (E,) destination submap (-1 invalid)
    T: torch.Tensor  # (E, 4, 4) src-submap -> dst-submap
    valid: torch.Tensor  # (E,)


# ---------------------------------------------------------------------------
# stage functions, shared by the serial and the sharded pipeline
# ---------------------------------------------------------------------------


def track_one_submap(
    grays: torch.Tensor,  # (F, H, W)
    depths: torch.Tensor,  # (F, H, W)
    prev_gray: torch.Tensor | None,  # (H, W) last frame of the previous submap; None for submap 0
    prev_depth: torch.Tensor | None,
    camera: PinholeCamera,
) -> SubmapTrack:
    """Dense VO within one submap from the identity at each pair (as the
    serial DenseSlam tracks; ref DenseSlam.cpp:22), and the boundary pair."""
    eye = torch.eye(4, dtype=torch.float32, device=grays.device)
    pyr = dense.preprocess_frame(grays[0], depths[0], camera)
    step = eye
    if prev_gray is not None:
        prev_pyr = dense.preprocess_frame(prev_gray, prev_depth, camera)
        step = se3.inverse_T(dense.dense_tracking(prev_pyr, pyr, camera).T_ts)
    rels, rmses = [eye], [torch.zeros((), device=grays.device)]
    for g, d in zip(grays[1:], depths[1:]):
        nxt = dense.preprocess_frame(g, d, camera)
        res = dense.dense_tracking(pyr, nxt, camera)
        rels.append(rels[-1] @ se3.inverse_T(res.T_ts))
        rmses.append(res.rmse)
        pyr = nxt
    return SubmapTrack(torch.stack(rels), step, torch.stack(rmses))


def chain_base_poses(rel_last: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """(S, 4, 4) world-from-submap-base poses from the boundary chain:
    T_base[s] = T_base[s - 1] @ rel_last[s - 1] @ steps[s]."""
    out = [torch.eye(4, dtype=rel_last.dtype, device=rel_last.device)]
    for s in range(1, rel_last.shape[0]):
        out.append(out[-1] @ rel_last[s - 1] @ steps[s])
    return torch.stack(out)


def build_submap_geometry(
    depths: torch.Tensor,  # (F, H, W)
    track: SubmapTrack,
    camera: PinholeCamera,
    voxel_size: float,
    capacity: int,
    params: global_reg.RansacParams,
) -> SubmapGeometry:
    """The submap's fused, downsampled model (ref DenseSlam.h:19-33
    GenerateSubmapModel + DenseSlam.cpp:75): every CLOUD_STRIDE-th frame in
    base coordinates, voxel-averaged, the first `capacity` voxels kept in
    key order (the JAX function's `nonzero(size=capacity)`), normals, FPFH."""
    pts_all, val_all = [], []
    for i in range(0, depths.shape[0], CLOUD_STRIDE):
        cloud = PointCloud.from_rgbd(depths[i], None, camera, depth_min=dense.MIN_DEPTH, depth_max=dense.MAX_DEPTH)
        T = track.rel[i]
        pts_all.append(cloud.points @ T[:3, :3].T + T[:3, 3])
        val_all.append(cloud.valid)
    pts = torch.cat(pts_all)
    fused = PointCloud(pts, torch.zeros_like(pts), torch.zeros_like(pts), torch.cat(val_all))
    ds = voxel_downsample(fused, voxel_size)
    n = ds.points.shape[0]
    dev = pts.device
    count = torch.sum(ds.valid)
    order = torch.argsort((~ds.valid).to(torch.uint8), stable=True)  # the valid entries first, in order
    if n < capacity:
        order = torch.cat([order, torch.full((capacity - n,), n - 1, dtype=order.dtype, device=dev)])
    keep_ok = torch.arange(capacity, device=dev) < count
    idx = torch.where(keep_ok, order[:capacity], n - 1)
    cpts = ds.points[idx]
    comp = PointCloud(cpts, torch.zeros_like(cpts), torch.zeros_like(cpts), ds.valid[idx] & keep_ok)
    nn = estimate_normals(comp, k=params.normal_k)
    feats = fpfh_mod.compute_fpfh(nn.points, nn.normals, nn.valid, radius=params.fpfh_radius, k=params.fpfh_k)
    return SubmapGeometry(nn.points, nn.normals, nn.valid, feats)


def _select(geos: SubmapGeometry, i: int) -> SubmapGeometry:
    return SubmapGeometry(*(a[i] for a in geos))


def register_one_submap(
    sm_idx: int,
    geo: SubmapGeometry,  # this submap
    prev_geo: SubmapGeometry,  # submap sm_idx - 1 (not read for submap 0)
    all_geo: SubmapGeometry,  # (S, ...) every submap
    base_poses: torch.Tensor,  # (S, 4, 4) odometry-chained base poses
    icp_threshold: float,
    params: global_reg.RansacParams,
    max_loops: int,
) -> SubmapEdges:
    """Consecutive ICP and the loop registrations of ONE submap against the
    older ones (ref DenseSlam.cpp:87-115); fixed shapes, gates on the device."""
    dev = geo.points.device
    e = 1 + max_loops
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    dst = torch.full((e,), -1, dtype=torch.int64, device=dev)
    ts = eye.repeat(e, 1, 1)
    ok = torch.zeros((e,), dtype=torch.bool, device=dev)

    def put(slot: int, target: int, good: torch.Tensor, T: torch.Tensor) -> None:
        dst[slot] = torch.where(good, target, -1)
        ts[slot] = torch.where(good, T, eye)
        ok[slot] = good

    if sm_idx > 0:  # consecutive ICP, from the odometry chain
        init = se3.inverse_T(base_poses[sm_idx - 1]) @ base_poses[sm_idx]
        res = icp.point_to_point(geo.points, geo.valid, prev_geo.points, prev_geo.valid,
                                 init_T=init, threshold=icp_threshold)
        good = torch.isfinite(res.rmse) & (res.num_inliers > ICP_MIN_INLIERS) & torch.isfinite(res.T).all()
        put(0, sm_idx - 1, good, res.T)
    src = global_reg.CloudFeatures(geo.points, geo.normals, geo.valid, geo.fpfh)
    for l in range(min(max_loops, sm_idx - 1)):  # loop closures vs older submaps (ref :106-115)
        older = _select(all_geo, l)
        reg = global_reg.register(src, global_reg.CloudFeatures(*older), params)
        refined = icp.point_to_point(geo.points, geo.valid, older.points, older.valid,
                                     init_T=reg.T, threshold=icp_threshold)
        good = reg.success & (refined.num_inliers > LOOP_MIN_INLIERS) & torch.isfinite(refined.T).all()
        put(1 + l, l, good, refined.T)
    return SubmapEdges(dst, ts, ok)


def solve_pose_graph(base_poses: np.ndarray, edges: SubmapEdges, geos: SubmapGeometry,
                     device) -> np.ndarray:
    """Pose-graph GN over the submap base poses (ref DenseSlam.cpp:120-125)
    from the gathered edges (stacked (S, E, ...)) and clouds; every rank
    solves the same system."""
    s = base_poses.shape[0]
    dst, ts, ok = (a.cpu().numpy() for a in edges)
    pts, val = geos.points.cpu().numpy(), geos.valid.cpu().numpy()
    edge_list = []
    for src in range(s):
        for slot in range(dst.shape[1]):
            if not ok[src, slot]:
                continue
            p_all = pts[src][val[src]]
            p = p_all[:: max(1, len(p_all) // MAX_EDGE_CORRS)][:MAX_EDGE_CORRS]
            T = ts[src, slot]
            edge_list.append({"src": src, "dst": int(dst[src, slot]), "p_src": p,
                              "p_dst": p @ T[:3, :3].T + T[:3, 3]})
    if not edge_list or s < 2:
        return base_poses
    pg = posegraph.build_edges(edge_list, corr_capacity=MAX_EDGE_CORRS, device=device)
    opt, _ = posegraph.optimize_pose_graph(torch.as_tensor(base_poses, device=device), pg, iters=POSE_GRAPH_ITERS)
    return opt.cpu().numpy()


class PipelineOut(NamedTuple):
    frame_poses: np.ndarray  # (S F, 4, 4) world-from-frame after the pose graph
    base: np.ndarray  # (S, 4, 4) optimised submap base poses
    edges: SubmapEdges  # stacked (S, E, ...)
    geos: SubmapGeometry  # stacked (S, ...)
    base_raw: np.ndarray  # (S, 4, 4) the odometry chain the registrations started from
    rmse: np.ndarray  # (S, F) tracking rmse


def _finish(tracks_rel: np.ndarray, rmse: np.ndarray, base: torch.Tensor, edges: SubmapEdges,
            geos: SubmapGeometry, device) -> PipelineOut:
    base_np = base.cpu().numpy()
    opt = solve_pose_graph(base_np, edges, geos, device)
    s, f = tracks_rel.shape[:2]
    frame_poses = np.einsum("sij,sfjk->sfik", opt, tracks_rel).reshape(s * f, 4, 4)
    return PipelineOut(frame_poses, opt, edges, geos, base_np, rmse)


def _frames(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)  # a copy: x may be a read-only map


def submap_pipeline_serial(
    grays, depths,  # (S, F, H, W) numpy (or array-like)
    camera: PinholeCamera,
    device: str | torch.device = "cuda",
    cloud_capacity: int = 1024,
) -> PipelineOut:
    """The stages one after the other on one device."""
    s = len(grays)
    params = global_reg.RansacParams(voxel_size=VOXEL_SIZE)
    tracks, geos = [], []
    for i in range(s):
        g, d = _frames(grays[i], device), _frames(depths[i], device)
        prev = (_frames(grays[i - 1][-1], device), _frames(depths[i - 1][-1], device)) if i else (None, None)
        tracks.append(track_one_submap(g, d, *prev, camera))
        geos.append(build_submap_geometry(d, tracks[-1], camera, VOXEL_SIZE, cloud_capacity, params))
    base = chain_base_poses(torch.stack([t.rel[-1] for t in tracks]), torch.stack([t.step for t in tracks]))
    all_geo = SubmapGeometry(*(torch.stack(a) for a in zip(*geos)))
    edges = [register_one_submap(i, geos[i], geos[i - 1] if i else geos[0], all_geo, base, ICP_THRESHOLD,
                                 params, max(s - 2, 0))
             for i in range(s)]
    edges = SubmapEdges(*(torch.stack(a) for a in zip(*edges)))
    rel = torch.stack([t.rel for t in tracks]).cpu().numpy()
    rmse = torch.stack([t.rmse for t in tracks]).cpu().numpy()
    return _finish(rel, rmse, base, edges, all_geo, device)


# ---------------------------------------------------------------------------
# the sharded pipeline
# ---------------------------------------------------------------------------

_GEO_COLS = (3, 3, 1, 33)  # points, normals, valid (as 0 / 1), fpfh


def _pack_geo(geo: SubmapGeometry) -> torch.Tensor:
    return torch.cat([geo.points, geo.normals, geo.valid[:, None].to(torch.float32), geo.fpfh], 1)


def _unpack_geo(packed: torch.Tensor) -> SubmapGeometry:
    p, n, v, f = packed.split(_GEO_COLS, -1)
    return SubmapGeometry(p.contiguous(), n.contiguous(), v[..., 0] > 0.5, f.contiguous())


def submap_pipeline_sharded(
    group: ShardGroup,
    grays, depths,  # (S, F, H, W) array-likes, S == world; each rank reads its own submap and one frame before
    camera: PinholeCamera,
    cloud_capacity: int = 1024,
) -> PipelineOut:
    """Submap `group.rank` on this rank; every rank returns the same
    `PipelineOut` as `submap_pipeline_serial`."""
    s, r, dev = len(grays), group.rank, group.device
    if s != group.world:
        raise ValueError(f"{s} submaps on {group.world} ranks: one submap per rank")
    params = global_reg.RansacParams(voxel_size=VOXEL_SIZE)
    g, d = _frames(grays[r], dev), _frames(depths[r], dev)
    prev = (_frames(grays[r - 1][-1], dev), _frames(depths[r - 1][-1], dev)) if r else (None, None)
    track = track_one_submap(g, d, *prev, camera)
    # stage 2: each rank's last relative pose and boundary step, chained everywhere
    chain = group.all_gather(torch.cat([track.rel[-1].reshape(16), track.step.reshape(16)]))
    base = chain_base_poses(chain[:, :16].reshape(s, 4, 4), chain[:, 16:].reshape(s, 4, 4))
    geo = build_submap_geometry(d, track, camera, VOXEL_SIZE, cloud_capacity, params)
    packed = _pack_geo(geo)
    prev_geo = _unpack_geo(group.ring_shift(packed))  # stage 4a: the previous submap's cloud
    all_geo = _unpack_geo(group.all_gather(packed))  # stage 4b: every submap's cloud
    edges = register_one_submap(r, geo, prev_geo, all_geo, base, ICP_THRESHOLD, params, max(s - 2, 0))
    e = edges.dst.shape[0]
    ge = group.all_gather(torch.cat([edges.dst[:, None].to(torch.float32), edges.T.reshape(e, 16),
                                     edges.valid[:, None].to(torch.float32)], 1))
    edges = SubmapEdges(ge[..., 0].to(torch.int64), ge[..., 1:17].reshape(s, e, 4, 4).contiguous(), ge[..., 17] > 0.5)
    f = track.rel.shape[0]
    tr = group.all_gather(torch.cat([track.rel.reshape(-1), track.rmse]))
    rel = tr[:, : f * 16].reshape(s, f, 4, 4).cpu().numpy()
    return _finish(rel, tr[:, f * 16 :].cpu().numpy(), base, edges, all_geo, dev)
