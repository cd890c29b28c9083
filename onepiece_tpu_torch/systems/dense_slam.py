"""DenseSlam: dense frame-to-frame VO + submap registration + pose graph.

Port of `onepiece_tpu/systems/dense_slam.py` (the reference's DenseFusion
system), with the same host loop and bookkeeping:

  per frame:
    - dense tracking against the previous frame (`odometry/dense.py`, one
      Gauss-Newton kernel launch per iteration on the card), then ONE transfer of the
      relative pose and rmse to the host
    - the world pose chain T_w_cur = T_w_prev @ inv(T_ts), kept in numpy
    - frames grouped into submaps of `submap_size`; every CLOUD_STRIDE-th
      frame's back-projected cloud is kept in submap-base coordinates
  per completed submap (`_finish_submap`):
    - merge the clouds, voxel-downsample, compact to the next capacity
    - normals + FPFH
    - ICP against the previous submap from the odometry chain (the nn1
      kernel on the card: `iters + 1` launches per ICP)
    - RANSAC registration against every older submap (loop closure), each
      success refined by ICP
    - pose-graph Gauss-Newton over the submap poses, then every frame pose
      re-anchored to its submap

After the scan, `reconstruct` is DenseFusion's post-hoc reconstruction:
the frames it is given (DenseFusion keeps every POSTHOC_STRIDE-th),
bilateral-filtered, fused into a `TSDFVolume` at the optimised poses, then
marching cubes and the vertex dedup.

Tensors live on `device` ("cuda", the default: the kernels; "cpu": their
plain versions). The host reads the device once per frame and a few times per
submap (the decisions of the loop are the host's, as in the JAX package).

While a profiler records (`utils/tracing.py`), a frame is the span
`loop.frame`; a submap's stages are `registration.cloud` (a kept frame's
cloud), `.merge`, `.downsample`, `.features` (normals and FPFH), `.icp`
(against the previous submap), `.global` (an older submap's feature match,
RanSaPC and RANSAC launch; counter `registration.global`), `.refine` (ICP
from an accepted registration; counter `registration.loop_edge` where it
makes an edge), `.pose_graph` and `.reanchor`; each line that waits for the
device is a `sync.<site>` span; `reconstruct` is `reconstruct.posthoc`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry.camera import PinholeCamera
from ..geometry.pointcloud import PointCloud, compact, merge, voxel_downsample
from ..integration.blocks import TSDFVolume
from ..odometry import dense
from ..ops.image import bilateral_filter
from ..ops.mesh_dedup import dedup_triangle_soup
from ..optimization import posegraph
from ..registration import global_reg, icp
from ..utils import tracing

SUBMAP_SIZE = 50  # frames per submap
CLOUD_STRIDE = 3  # fuse every 3rd frame of a submap
MAX_EDGE_CORRS = 512
POSTHOC_STRIDE = 8  # the post-hoc reconstruction fuses every 8th frame
POSTHOC_VOXEL = 0.02  # m
TRUNCATION_VOXELS = 5  # the post-hoc truncation band, in voxels (0.1 m at 0.02)


def _to_host(*ts: torch.Tensor) -> list[np.ndarray]:
    """Several small tensors in one device-to-host transfer (float64 holds
    float32 and int counts exactly)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in ts]).cpu().numpy()
    out, i = [], 0
    for t in ts:
        out.append(flat[i : i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


@dataclasses.dataclass
class DenseSlam:
    camera: PinholeCamera
    device: str | torch.device = "cuda"
    submap_size: int = SUBMAP_SIZE
    voxel_size: float = 0.05
    icp_threshold: float = 0.1

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.poses: list[np.ndarray] = []  # world-from-frame, per frame
        self.prev_pyramid: dense.FramePyramid | None = None
        self.submap_base: list[int] = []  # first frame index of each submap
        self.submap_poses: list[np.ndarray] = []  # world-from-submap-base
        self.rel_in_submap: list[np.ndarray] = []  # per frame: T_base_frame
        self.frame_submap: list[int] = []
        self.submap_clouds: list[PointCloud] = []  # downsampled, base coords
        self.submap_features: list[global_reg.CloudFeatures] = []
        self.edges: list[dict] = []
        self._pending_clouds: list[PointCloud] = []
        self.frame_count = 0
        self.metrics: list[dict] = []

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def update_frame(self, gray, depth) -> dict:
        """Track one (H, W) gray + depth frame (numpy or tensor); finishes
        the submap on its last frame."""
        fidx = self.frame_count
        with tracing.span("loop.frame", frame=fidx):
            return self._update_frame(fidx, gray, depth)

    def _update_frame(self, fidx: int, gray, depth) -> dict:
        self.frame_count += 1
        depth = self._tensor(depth)
        pyr = dense.preprocess_frame(self._tensor(gray), depth, self.camera)
        if fidx == 0:
            T_world, T_ts = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
            rmse = 0.0
        else:
            res = dense.dense_tracking(self.prev_pyramid, pyr, self.camera)
            with tracing.sync("frame_pose"):  # the frame's one sync
                T_ts, rmse = _to_host(res.T_ts, res.rmse)
            T_ts = T_ts.astype(np.float32)
            T_world = self.poses[-1] @ np.linalg.inv(T_ts)
            rmse = float(rmse)
        self.prev_pyramid = pyr

        sm_idx = fidx // self.submap_size
        if sm_idx == len(self.submap_base):
            self.submap_base.append(fidx)
            self.submap_poses.append(T_world.astype(np.float32))
        self.frame_submap.append(sm_idx)
        self.rel_in_submap.append(np.linalg.inv(self.submap_poses[sm_idx]) @ T_world)
        self.poses.append(T_world)

        if (fidx - self.submap_base[sm_idx]) % CLOUD_STRIDE == 0:
            with tracing.span("registration.cloud", frame=fidx):
                cloud = PointCloud.from_rgbd(depth, None, self.camera, dense.MIN_DEPTH, dense.MAX_DEPTH)
                with tracing.sync("cloud_pose"):
                    T_base = self._tensor(self.rel_in_submap[-1])
                self._pending_clouds.append(cloud.transform(T_base))

        out = {"frame": fidx, "rmse": rmse, "submap": sm_idx, "T_ts": T_ts}
        if fidx > 0 and (fidx + 1) % self.submap_size == 0:
            out.update(self._finish_submap(sm_idx))
        self.metrics.append(out)
        return out

    def _finish_submap(self, sm_idx: int) -> dict:
        """Fuse the submap's cloud, then register it to the older submaps."""
        with tracing.span("registration.merge", submap=sm_idx):
            fused = merge(*self._pending_clouds)
        self._pending_clouds = []
        with tracing.span("registration.downsample"):
            ds = compact(voxel_downsample(fused, self.voxel_size))
        params = global_reg.RansacParams(voxel_size=self.voxel_size)
        self.submap_clouds.append(ds)
        with tracing.span("registration.features"):
            self.submap_features.append(global_reg.extract_features(ds, params))

        info = {"submap_registered": sm_idx, "icp_ok": False, "loops": 0}
        if sm_idx == 0:
            return info

        # ICP against the previous submap, from the odometry chain
        init = np.linalg.inv(self.submap_poses[sm_idx - 1]) @ self.submap_poses[sm_idx]
        prev, cur = self.submap_clouds[sm_idx - 1], self.submap_clouds[sm_idx]
        with tracing.span("registration.icp", src=sm_idx, dst=sm_idx - 1):
            with tracing.sync("icp_init"):
                init_T = self._tensor(init)
            res = icp.point_to_point(
                cur.points, cur.valid, prev.points, prev.valid,
                init_T=init_T, threshold=self.icp_threshold,
            )
            with tracing.sync("icp_result"):
                T_icp, rmse_icp, nin_icp = _to_host(res.T, res.rmse, res.num_inliers)
            if np.isfinite(rmse_icp) and int(nin_icp) > 50:
                self._add_edge(sm_idx, sm_idx - 1, T_icp.astype(np.float32), cur)
                info["icp_ok"] = True

        # RANSAC registration against every older submap (loop closures)
        for older in range(sm_idx - 1):
            with tracing.span("registration.global", src=sm_idx, dst=older):
                tracing.count("registration.global")
                reg = global_reg.register(self.submap_features[sm_idx], self.submap_features[older], params)
                with tracing.sync("global_success"):
                    success = bool(reg.success)
            if success:
                old = self.submap_clouds[older]
                with tracing.span("registration.refine", src=sm_idx, dst=older):
                    refined = icp.point_to_point(
                        cur.points, cur.valid, old.points, old.valid,
                        init_T=reg.T, threshold=self.icp_threshold,
                    )
                    with tracing.sync("refine_result"):
                        T_ref, nin_ref = _to_host(refined.T, refined.num_inliers)
                    if int(nin_ref) > 100:
                        tracing.count("registration.loop_edge")
                        self._add_edge(sm_idx, older, T_ref.astype(np.float32), cur)
                        info["loops"] += 1

        self._optimize()
        return info

    def _add_edge(self, src_sm: int, dst_sm: int, T_src_to_dst: np.ndarray, src_cloud: PointCloud) -> None:
        """Edge: up to MAX_EDGE_CORRS evenly strided points p of the source
        submap and their images T p in the destination submap's frame; the
        edge keeps T too."""
        with tracing.sync("edge_points", 2):
            pts = src_cloud.points.cpu().numpy()
            v = src_cloud.valid.cpu().numpy()
        p = pts[v][:: max(1, v.sum() // MAX_EDGE_CORRS)][:MAX_EDGE_CORRS]
        q = p @ T_src_to_dst[:3, :3].T + T_src_to_dst[:3, 3]
        self.edges.append({"src": src_sm, "dst": dst_sm, "p_src": p, "p_dst": q, "T": T_src_to_dst})

    def _optimize(self) -> None:
        n = len(self.submap_poses)
        if n < 2 or not self.edges:
            return
        with tracing.span("registration.pose_graph", poses=n, edges=len(self.edges)):
            with tracing.sync("pose_graph_upload", 7):  # six edge tensors and the poses
                edges = posegraph.build_edges(self.edges, corr_capacity=MAX_EDGE_CORRS, device=self.device)
                poses = self._tensor(np.stack(self.submap_poses))
            opt, _ = posegraph.optimize_pose_graph(poses, edges, iters=5)
            with tracing.sync("pose_graph_fetch"):
                opt = opt.cpu().numpy()
        with tracing.span("registration.reanchor"):
            self.submap_poses = [opt[i] for i in range(n)]
            for i in range(len(self.poses)):  # re-anchor every frame to its submap
                self.poses[i] = self.submap_poses[self.frame_submap[i]] @ self.rel_in_submap[i]

    def trajectory(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))


def reconstruct(poses, frames, camera: PinholeCamera, voxel_size: float = POSTHOC_VOXEL, device="cuda"):
    """DenseFusion's post-hoc reconstruction (the reference's
    `DenseFusion.cpp` after tracking). `frames` yields (index, depth (H, W)
    m, rgb (H, W, 3) in [0, 1]) of the frames to fuse (DenseFusion keeps
    every POSTHOC_STRIDE-th); each is bilateral-filtered and fused with its
    colour at `poses[index]` (world-from-camera, e.g.
    `DenseSlam.trajectory()`) into a `TSDFVolume(voxel_size, truncation
    TRUNCATION_VOXELS voxels)` on `device`; then marching cubes over every
    block and the vertex dedup. Returns (volume, (vertices (V, 3), faces
    (F, 3), colours (V, 3)))."""
    with tracing.span("reconstruct.posthoc"):
        vol = TSDFVolume(voxel_size=voxel_size, truncation=voxel_size * TRUNCATION_VOXELS, device=device)
        for i, depth, rgb in frames:
            with tracing.span("reconstruct.integrate", frame=i):
                depth = torch.as_tensor(depth, dtype=torch.float32).to(vol.device)
                rgb = torch.as_tensor(rgb, dtype=torch.float32).to(vol.device)
                vol.integrate(bilateral_filter(depth), rgb, poses[i], camera)
        mesh = dedup_triangle_soup(*vol.extract_mesh_tensors())
    return vol, mesh


def _cloud_from_numpy(c, device) -> PointCloud:
    return PointCloud(*(torch.tensor(np.asarray(getattr(c, f.name)), device=device)
                        for f in dataclasses.fields(PointCloud)))


def state_from_numpy(state, camera: PinholeCamera, device) -> DenseSlam:
    """A DenseSlam carrying the state of the JAX package's DenseSlam
    `state` (its attributes, with numpy or array-like leaves), on `device`:
    poses, submap bookkeeping, submap clouds and features, edges, pending
    clouds, the previous frame's pyramid and the frame count. Taken at a
    submap boundary, both then compute the same next registration."""
    slam = DenseSlam(camera, device, submap_size=state.submap_size,
                     voxel_size=state.voxel_size, icp_threshold=state.icp_threshold)

    def mats(xs):
        return [np.array(x, dtype=np.float32) for x in xs]

    slam.poses = mats(state.poses)
    slam.submap_poses = mats(state.submap_poses)
    slam.rel_in_submap = mats(state.rel_in_submap)
    slam.submap_base = [int(i) for i in state.submap_base]
    slam.frame_submap = [int(i) for i in state.frame_submap]
    slam.frame_count = int(state.frame_count)
    slam.submap_clouds = [_cloud_from_numpy(c, device) for c in state.submap_clouds]
    slam._pending_clouds = [_cloud_from_numpy(c, device) for c in state._pending_clouds]
    slam.submap_features = [
        global_reg.CloudFeatures(*(torch.tensor(np.asarray(a), device=device) for a in f))
        for f in state.submap_features
    ]
    slam.edges = [
        {"src": int(e["src"]), "dst": int(e["dst"]),
         "p_src": np.array(e["p_src"], np.float32), "p_dst": np.array(e["p_dst"], np.float32)}
        for e in state.edges
    ]
    if state.prev_pyramid is not None:
        slam.prev_pyramid = dense.FramePyramid(
            *(tuple(torch.tensor(np.asarray(a), device=device) for a in field) for field in state.prev_pyramid))
    return slam
