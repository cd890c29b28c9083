"""The comparison that decides `correct` for the DenseFusion configuration
(`configs/tum_densefusion.json`; the system `systems/dense_slam.py`), the
plain DenseSlam route it is made of, and its control.

The plain route is a frozen copy of the port's DenseSlam on its plain
path: the Gauss-Newton tracker and the TSDF, marching-cubes and dedup
steps of `plain_ops.py` (`block_hash.py` is not needed: the post-hoc
volume allocates on the host), the registration steps of
`registration.py`, and the pose graph of `fba/`. It runs in float32 with
TF32 off, on the frames' device, and launches no kernel of the program.

Each stage is judged from the program's own state of the judged scan, so
that a rounding change in one stage does not carry into the next:

- tracking: the frame-to-frame motion of every 10th pair of frames
  (frames 10k+4 and 10k+5), recomputed from the two frames alone, against
  the program's (`pose_gap_m`, `rot_gap_rad`); and the program's host
  bookkeeping replayed from its motions and its solves' poses (each
  frame's pose in its submap, the submap poses, the re-anchored
  trajectory), which must agree exactly (in `pose_gap_m`);
- submap clouds: each submap's merged, downsampled cloud rebuilt from its
  frames at the program's poses in the submap: `cloud_gap_m`, the largest
  point gap (None where the counts differ);
- features: each submap's normals and FPFH recomputed from the program's
  cloud: `normal_gap` and `fpfh_gap`, the largest entry gap (None where
  the points differ);
- edges: each ICP edge (from the program's initial pose) and each global
  registration with its ICP refinement, recomputed from the program's
  submap clouds and features with the generator seeded as the program
  seeds it: `graph_mismatch` (edges made in one only), `edge_gap_m` and
  `edge_rot_gap_rad` of the edges both made;
- pose graph: each solve re-run from the program's poses before it and its
  edges: `submap_pose_gap_m`;
- volume and mesh: the post-hoc volume re-fused at the program's optimised
  poses, held to the program's by block key (`weight_mismatch`, `sdf_gap`,
  `color_gap`), and the program's volume re-meshed (`vertex_gap_m`,
  `vertex_color_gap`).

The control (`control_scan`) is the whole plain route with every stored
image, point, normal, descriptor, edge transform, solved submap pose, pool
row and mesh vertex rounded through bfloat16: the precision below the
float32 the configuration states. It returns what the program returns, so
the comparison judges it in the program's place. A number that cannot be
read reads None and fails.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import dense_fusion as dense_ref
from . import plain_ops as P
from . import registration as R
from .fba.optimization import posegraph
from .fused_dense_fusion import mesh_gaps, pool_gaps

MAX_EDGE_CORRS = 512
FIRST_MAX_BLOCKS = 4096  # the post-hoc volume's first cap of touched keys a frame
KEY_STRIDE = 4  # its pixel stride for the touched keys
TRUNCATION_VOXELS = 5  # its truncation band, in voxels
PAIR_EVERY = 10  # tracking: one pair of frames in ten
PAIR_OFFSET = 5  # ... the pair (10k + 4, 10k + 5)


class SlamOut(NamedTuple):
    """What a scan gives its user (the trajectory, the volume, the mesh) and
    the state the stages are judged from."""

    poses: torch.Tensor  # (N, 4, 4) optimised world-from-camera, float32
    motions: torch.Tensor  # (N, 4, 4) each frame's T_ts onto the one before (frame 0: the identity)
    rel: torch.Tensor  # (N, 4, 4) each frame's pose in its submap
    submap_size: int
    clouds: list  # per submap: registration.Cloud (the program's, compacted)
    features: list  # per submap: registration.Features
    edges: list  # {"src", "dst", "T", "p_src", "p_dst"} (numpy), in the order made
    solves: list  # (submap poses before (n, 4, 4), edges made by then, submap poses after), numpy
    vox: torch.Tensor  # (R, 5, 512) the post-hoc volume's rows [sdf, weight, r, g, b]
    coords: torch.Tensor  # (B, 3) int32 block coords of rows 0..B-1
    verts: torch.Tensor  # (V, 3) the deduplicated mesh
    faces: torch.Tensor  # (F, 3) int64
    colors: torch.Tensor  # (V, 3)


def _no_tf32() -> None:
    """Float32 products in float32: TF32 off (PyTorch's default for matmul,
    set here for both libraries; the judge runs after the program's work)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dev_T(T: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(T), dtype=torch.float32).to(device)


def _host(rnd, T: np.ndarray) -> np.ndarray:
    """`rnd` applied to host float32 numbers."""
    return T if rnd is P.exact else rnd(torch.from_numpy(np.ascontiguousarray(T, np.float32))).numpy()


# --- the plain route, stage by stage -------------------------------------------------


def track_pair(g0, d0, g1, d1, cfg: dict, rnd=P.exact) -> torch.Tensor:
    """T_ts of frame 0 onto frame 1 from the identity (DenseSlam starts each
    frame there)."""
    cam = dense_ref.camera(cfg)
    levels, iters = len(cfg["iters"]), tuple(cfg["iters"])
    a = P.preprocess_frame(rnd(g0), rnd(d0), cam, levels, rnd)
    b = P.preprocess_frame(rnd(g1), rnd(d1), cam, levels, rnd)
    return P.dense_tracking(a, b, cam, torch.eye(4, dtype=torch.float32, device=g0.device), iters, rnd)


def submap_frames(k: int, n: int, cfg: dict) -> list[int]:
    """The frames whose clouds submap k keeps: every cloud_stride-th from its first."""
    base = k * cfg["submap_size"]
    return list(range(base, min(base + cfg["submap_size"], n), cfg["cloud_stride"]))


def submap_cloud(depths, rels, frames: list[int], cfg: dict, rnd=P.exact) -> R.Cloud:
    cam = dense_ref.camera(cfg)
    clouds = [R.frame_cloud(rnd(depths[f]), cam, _dev_T(rels[f], depths.device), P.MIN_DEPTH, P.MAX_DEPTH, rnd)
              for f in frames]
    return R.compact(R.voxel_downsample(R.merge(*clouds), cfg["voxel_size"]))


def make_edge(src: int, dst: int, T: np.ndarray, cloud: R.Cloud) -> dict:
    """Up to MAX_EDGE_CORRS evenly strided points of the source cloud and
    their images under T, as DenseSlam keeps an edge."""
    pts, v = cloud.points.cpu().numpy(), cloud.valid.cpu().numpy()
    p = pts[v][:: max(1, v.sum() // MAX_EDGE_CORRS)][:MAX_EDGE_CORRS]
    return {"src": src, "dst": dst, "T": T, "p_src": p, "p_dst": p @ T[:3, :3].T + T[:3, 3]}


def submap_edges(k: int, clouds: list, features: list, poses_before: np.ndarray, cfg: dict, counts=None,
                 rnd=P.exact) -> list:
    """The edges of submap k: ICP against k - 1 from the odometry chain, then
    each older submap registered and, where that succeeds, refined by ICP;
    each edge's T stored through `rnd`. `counts`, if given, gets (queries,
    references, valid references) of each ICP call and the correspondences
    of each registration."""
    edges, thr, iters = [], cfg["icp_threshold"], cfg["icp_iters"]
    cur, dev = clouds[k], clouds[k].points.device
    if counts is not None:
        counts["icp"].append((cur.points.shape[0], clouds[k - 1].points.shape[0], int(clouds[k - 1].valid.sum())))
    init = np.linalg.inv(poses_before[k - 1]) @ poses_before[k]
    T, n, rmse = R.icp(cur.points, cur.valid, clouds[k - 1].points, clouds[k - 1].valid, _dev_T(init, dev), thr,
                       iters)
    T, n, rmse = (x.cpu().numpy() for x in (T, n, rmse))
    if np.isfinite(rmse) and int(n) > 50:
        edges.append(make_edge(k, k - 1, _host(rnd, T.astype(np.float32)), cur))
    for older in range(k - 1):
        if counts is not None:
            counts["ransac"].append(features[k].points.shape[0])
        reg = R.register(features[k], features[older], cfg)
        if bool(reg.success):
            old = clouds[older]
            if counts is not None:
                counts["icp"].append((cur.points.shape[0], old.points.shape[0], int(old.valid.sum())))
            T, n, _ = R.icp(cur.points, cur.valid, old.points, old.valid, reg.T, thr, iters)
            if int(n.cpu()) > 100:
                edges.append(make_edge(k, older, _host(rnd, T.cpu().numpy().astype(np.float32)), cur))
    return edges


def solve(poses_before: np.ndarray, edges: list, cfg: dict, device) -> np.ndarray:
    """The submap poses after the pose graph's Gauss-Newton steps."""
    packed = posegraph.build_edges(edges, corr_capacity=MAX_EDGE_CORRS, device=device)
    opt, _ = posegraph.optimize_pose_graph(_dev_T(np.stack(poses_before), device), packed,
                                           iters=cfg["pose_graph_iters"])
    return opt.cpu().numpy()


def posthoc_pool(depths, rgbs, poses, cfg: dict, rnd=P.exact, counts: list | None = None) -> dense_ref.Pool:
    """Every posthoc_stride-th frame, bilateral-filtered, fused with its
    colour at `poses` into a fresh pool; a block takes a row the first time
    a frame touches it. `counts`, if given, gets (touched blocks, voxels
    updated, of them from weight 0) per frame."""
    cam = dense_ref.camera(cfg)
    dev = depths.device
    voxel = cfg["posthoc_voxel"]
    trunc = voxel * TRUNCATION_VOXELS
    rows: dict[int, int] = {}
    vox = P.make_pool(1024, dev)
    max_blocks = FIRST_MAX_BLOCKS
    for i in range(0, depths.shape[0], cfg["posthoc_stride"]):
        d = rnd(P.bilateral_filter(rnd(depths[i])))
        T_wc = _dev_T(poses[i], dev)
        while True:
            keys = P.touched_block_keys(d, T_wc, cam.fx, cam.fy, cam.cx, cam.cy, voxel, trunc, max_blocks,
                                        KEY_STRIDE)
            live = keys[keys != P.INVALID_KEY]
            if live.shape[0] < max_blocks:
                break
            max_blocks *= 2
        for k in live.tolist():
            rows.setdefault(k, len(rows))
        if len(rows) > vox.shape[0] - 1:  # the last row is the trash row
            grown = P.make_pool(2 * len(rows), dev)
            grown[: vox.shape[0] - 1] = vox[:-1]
            vox = grown
        slots = torch.tensor([rows[k] for k in live.tolist()], dtype=torch.int32, device=dev)
        img = torch.cat([d[None], rnd(rgbs[i]).permute(2, 0, 1)])
        upd, fresh = P.integrate_rows(vox, live, slots, img, P.inverse_T(T_wc), cam.fx, cam.fy, cam.cx, cam.cy,
                                      voxel, trunc, cfg["max_weight"])
        if rnd is not P.exact:
            vox[slots.long()] = rnd(vox[slots.long()])
        if counts is not None:
            counts.append((int(live.shape[0]), upd, fresh))
    keys = torch.tensor(list(rows), dtype=torch.int32, device=dev)
    coords = torch.stack([(keys >> 20) & 1023, (keys >> 10) & 1023, keys & 1023], -1) - 512
    return dense_ref.Pool(vox, coords.to(torch.int32), 0)


def control_scan(grays, depths, rgbs, cfg: dict) -> SlamOut:
    """The whole plain route in bfloat16 storage, in the program's place."""
    _no_tf32()
    rnd, dev, n = P.bf16, depths.device, depths.shape[0]
    rel, submap_poses, poses, motions = [], [], [], [np.eye(4, dtype=np.float32)]
    clouds, features, edges, solves = [], [], [], []
    T_w = np.eye(4, dtype=np.float32)
    for i in range(n):
        if i:
            motions.append(track_pair(grays[i - 1], depths[i - 1], grays[i], depths[i], cfg, rnd).cpu().numpy())
            T_w = poses[-1] @ np.linalg.inv(motions[-1])
        k = i // cfg["submap_size"]
        if k == len(submap_poses):
            submap_poses.append(T_w.astype(np.float32))
        rel.append(np.linalg.inv(submap_poses[k]) @ T_w)
        poses.append(T_w)
        if i > 0 and (i + 1) % cfg["submap_size"] == 0:
            cloud = submap_cloud(depths, rel, submap_frames(k, n, cfg), cfg, rnd)
            clouds.append(cloud)
            features.append(R.extract_features(cloud, cfg, rnd))
            if k:
                before = np.stack(submap_poses)
                edges += submap_edges(k, clouds, features, before, cfg, rnd=rnd)
                if edges:
                    submap_poses = list(_host(rnd, solve(before, edges, cfg, dev)))
                    poses = [submap_poses[j // cfg["submap_size"]] @ rel[j] for j in range(len(poses))]
                solves.append((before, len(edges), np.stack(submap_poses)))
    poses_t = torch.from_numpy(np.stack(poses)).to(dev)
    pool = posthoc_pool(depths, rgbs, np.stack(poses), cfg, rnd)
    v, f, c, _ = dense_ref.mesh(pool.vox, pool.coords, cfg["posthoc_voxel"])
    return SlamOut(poses_t, torch.from_numpy(np.stack(motions)).to(dev), torch.from_numpy(np.stack(rel)).to(dev),
                   cfg["submap_size"], clouds, features, edges, solves, pool.vox, pool.coords, rnd(v), f, rnd(c))


# --- the comparison ----------------------------------------------------------------


def _rot_gap(Ra, Rb) -> float:
    return float(np.linalg.norm(Ra - Rb) / 2**0.5)


def tracking_gaps(out: SlamOut, grays, depths, cfg: dict) -> dict:
    motions = out.motions.cpu().numpy()
    dt, dr = 0.0, 0.0
    for i in range(PAIR_OFFSET, depths.shape[0], PAIR_EVERY):
        ref = track_pair(grays[i - 1], depths[i - 1], grays[i], depths[i], cfg).double().cpu().numpy()
        prog = motions[i].astype(np.float64)
        dt = max(dt, float(np.linalg.norm(prog[:3, 3] - ref[:3, 3])))
        dr = max(dr, _rot_gap(prog[:3, :3], ref[:3, :3]))
    return dict(pose_gap_m=max(dt, chain_gap(out, motions)), rot_gap_rad=dr)


def chain_gap(out: SlamOut, motions: np.ndarray) -> float:
    """DenseSlam's host bookkeeping replayed in its own float32 numpy steps
    from the program's motions, with each pose-graph solve's poses taken
    from the program: the largest gap of the poses in the submaps, the
    submap poses before each solve and the trajectory against the
    program's (0 where the program keeps its books)."""
    size, n = out.submap_size, motions.shape[0]
    poses, sub, rel, befores = [], [], [], []
    for i in range(n):
        T_world = np.eye(4, dtype=np.float32) if i == 0 else poses[-1] @ np.linalg.inv(motions[i])
        k = i // size
        if k == len(sub):
            sub.append(T_world.astype(np.float32))
        rel.append(np.linalg.inv(sub[k]) @ T_world)
        poses.append(T_world)
        if i >= size and (i + 1) % size == 0 and len(befores) < len(out.solves):
            befores.append(np.stack(sub))
            _, n_edges, after = out.solves[len(befores) - 1]
            if n_edges and len(sub) > 1:
                sub = [after[j] for j in range(len(sub))]
                poses = [sub[j // size] @ rel[j] for j in range(len(poses))]
    gaps = [np.abs(np.stack(rel) - out.rel.cpu().numpy()).max(),
            np.abs(np.stack(poses) - out.poses.cpu().numpy()).max()]
    gaps += [np.abs(b - s[0]).max() if b.shape == s[0].shape else np.inf for b, s in zip(befores, out.solves)]
    return float(max(gaps))


def cloud_gap(out: SlamOut, depths, cfg: dict) -> float | None:
    rels = out.rel.cpu().numpy()
    gap = 0.0
    for k, prog in enumerate(out.clouds):
        ref = submap_cloud(depths, rels, submap_frames(k, depths.shape[0], cfg), cfg)
        if prog.points.shape != ref.points.shape or not torch.equal(prog.valid, ref.valid):
            return None
        v = ref.valid
        gap = max(gap, float((prog.points[v] - ref.points[v]).abs().max()) if bool(v.any()) else 0.0)
    return gap


def feature_gaps(out: SlamOut, cfg: dict) -> dict:
    """Each submap's normals and FPFH recomputed from the program's cloud,
    against the program's features."""
    dn, df = 0.0, 0.0
    for cloud, prog in zip(out.clouds, out.features):
        ref = R.extract_features(cloud, cfg)
        if not (torch.equal(prog.points, ref.points) and torch.equal(prog.valid, ref.valid)
                and prog.normals.shape == ref.normals.shape and prog.fpfh.shape == ref.fpfh.shape):
            return dict(normal_gap=None, fpfh_gap=None)
        dn = max(dn, float((prog.normals - ref.normals).abs().max()))
        df = max(df, float((prog.fpfh - ref.fpfh).abs().max()))
    return dict(normal_gap=dn, fpfh_gap=df)


def edge_gaps(out: SlamOut, cfg: dict, counts=None) -> dict:
    """The edges recomputed from the program's clouds and features, against
    the program's."""
    ref_edges = []
    for k, (before, _, _) in zip(range(1, len(out.clouds)), out.solves):
        ref_edges += submap_edges(k, out.clouds, out.features, before, cfg, counts)
    prog = {(e["src"], e["dst"]): e["T"] for e in out.edges}
    ref = {(e["src"], e["dst"]): e["T"] for e in ref_edges}
    both = prog.keys() & ref.keys()
    dt = max((float(np.linalg.norm(prog[e][:3, 3] - ref[e][:3, 3])) for e in both), default=0.0)
    dr = max((_rot_gap(prog[e][:3, :3], ref[e][:3, :3]) for e in both), default=0.0)
    return dict(graph_mismatch=float(len(prog.keys() ^ ref.keys())), edge_gap_m=dt, edge_rot_gap_rad=dr)


def pose_graph_gap(out: SlamOut, cfg: dict) -> float | None:
    """Each solve re-run from the program's poses before it and the edges it
    had, against the program's poses after it."""
    dev, gap = out.poses.device, 0.0
    for before, n_edges, after in out.solves:
        want = solve(before, out.edges[:n_edges], cfg, dev) if n_edges and len(before) > 1 else before
        if want.shape != after.shape:
            return None
        gap = max(gap, float(np.abs(want[:, :3, 3] - after[:, :3, 3]).max()))
    return gap


STAGES = ("pose_gap_m", "rot_gap_rad", "cloud_gap_m", "normal_gap", "fpfh_gap", "graph_mismatch", "edge_gap_m",
          "edge_rot_gap_rad", "submap_pose_gap_m", "weight_mismatch", "sdf_gap", "color_gap", "vertex_gap_m", "vertex_color_gap")


def judge(out: SlamOut, grays, depths, rgbs, cfg: dict) -> dict:
    """Every number of the comparison for one scan's outputs."""
    _no_tf32()
    n = depths.shape[0]
    whole = n // cfg["submap_size"]
    if (out.poses.shape[0] != n or out.motions.shape[0] != n or out.rel.shape[0] != n or len(out.clouds) != whole
            or len(out.solves) != max(whole - 1, 0)):
        return dict.fromkeys(STAGES)
    readings = tracking_gaps(out, grays, depths, cfg)
    readings["cloud_gap_m"] = cloud_gap(out, depths, cfg)
    readings.update(feature_gaps(out, cfg))
    readings.update(edge_gaps(out, cfg))
    readings["submap_pose_gap_m"] = pose_graph_gap(out, cfg)
    pool = posthoc_pool(depths, rgbs, out.poses.cpu().numpy(), cfg)
    readings.update(pool_gaps(out.vox, out.coords, pool))
    del pool
    v, f, c, _ = dense_ref.mesh(out.vox, out.coords, cfg["posthoc_voxel"])
    readings.update(mesh_gaps((out.verts, out.faces, out.colors), (v, f, c)))
    return readings


def recount(out: SlamOut, grays, depths, rgbs, cfg: dict) -> dict:
    """The traced scan's work as the plain route redoes it: the shapes of
    each ICP call and each registration (for nn1 and RANSAC)."""
    counts = {"icp": [], "ransac": []}
    if len(out.solves) == len(out.clouds) - 1:
        edge_gaps(out, cfg, counts)
    return counts
