"""BASlam: sparse keyframe SLAM with world-point tracks and full bundle
adjustment, with the frame loop on the host.

Port of `onepiece_tpu/systems/baslam.py` (ref: example/BAFusion/BASlam.
{h,cpp}): FBASlam's front end (`systems/fbaslam.HostLoopSlam`), but the
inlier matches are chained into world-point tracks (local -> global index
maps, ref BASlam.cpp:89-150) by host numpy over the fetched correspondences,
and the optimisation is full bundle adjustment over the world points and
the keyframe poses (ref BASlam.cpp:281-289) through `optimization/bundle.
optimize`: on the card every LM step's Schur reduction and back-substitution
are the hand-written kernel of `csrc/ba_schur.cu`.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from ..odometry import sparse
from ..optimization import bundle
from .fbaslam import HostLoopSlam


@dataclasses.dataclass
class BASlam(HostLoopSlam):
    ba_every: int = 1  # run BA on every ba_every-th keyframe

    CORR_FIELDS = ("corr_src", "corr_valid", "corr_idx")
    KEEPS_UV = True

    def __post_init__(self):
        super().__post_init__()
        self.world_points: list[np.ndarray] = []
        self.track_of_kp: list[np.ndarray] = []  # per keyframe: (K,) global track id or -1
        self.keyframe_uv: list[np.ndarray] = []  # per keyframe: (K, 2) keypoint pixels, on the host
        self.observations: list[tuple[int, int, float, float]] = []  # (keyframe, track, u, v)

    def _bootstrap(self, frame: sparse.SparseFrame) -> None:
        super()._bootstrap(frame)
        self._keyframe_added(frame.kp.uv.cpu().numpy())

    def _keyframe_added(self, uv: np.ndarray) -> None:
        self.track_of_kp.append(np.full(self.max_keypoints, -1, np.int64))
        self.keyframe_uv.append(np.asarray(uv, np.float32))

    def _add_observation(self, kf: int, pid: int, uv: np.ndarray) -> None:
        self.observations.append((kf, pid, float(uv[0]), float(uv[1])))

    def _link_tracks(self, src_kf: int, dst_kf: int, res) -> int:
        """Extend or create tracks from the inlier matches between two
        keyframes (ref BASlam.cpp:89-150); `res` holds host arrays
        corr_src (K, 3), corr_valid (K,) and corr_idx (K,), the matched
        target keypoint of each source keypoint. Returns the number of
        linked correspondences."""
        v = np.asarray(res.corr_valid).astype(bool)
        src_pts = np.asarray(res.corr_src, np.float32)
        match_j = np.asarray(res.corr_idx)
        src_tracks = self.track_of_kp[src_kf]
        dst_tracks = self.track_of_kp[dst_kf]
        src_uv = self.keyframe_uv[src_kf]
        dst_uv = self.keyframe_uv[dst_kf]
        T_src = self.keyframe_poses[src_kf]
        linked = 0
        for i in np.nonzero(v)[0]:
            j = int(match_j[i])
            tid = src_tracks[i]
            if tid < 0 and dst_tracks[j] >= 0:
                tid = dst_tracks[j]
            if tid < 0:
                # a new world point at the source keypoint's world position
                pw = T_src[:3, :3] @ src_pts[i] + T_src[:3, 3]
                tid = len(self.world_points)
                self.world_points.append(pw.astype(np.float32))
                self._add_observation(src_kf, tid, src_uv[i])
            if src_tracks[i] < 0:
                src_tracks[i] = tid
            if dst_tracks[j] < 0:
                dst_tracks[j] = tid
                self._add_observation(dst_kf, tid, dst_uv[j])
            linked += 1
        return linked

    def _link(self, src_kf: int, dst_kf: int, corr: dict) -> int:
        return self._link_tracks(src_kf, dst_kf, types.SimpleNamespace(**corr))

    def _after_keyframes(self, new_kfs: list[int]) -> None:
        # BA only if one of the new keyframes falls on the ba_every schedule
        # (at a chunk boundary: one of the chunk's)
        if any(g % self.ba_every == 0 for g in new_kfs):
            self.optimize()

    def optimize(self, max_iters: int = 10) -> float | None:
        """Full BA over the keyframe poses and the world points seen at least
        twice (ref BASlam.cpp:281-289): the host-controlled LM loop of
        `bundle.optimize`. Returns the mean squared reprojection error, or
        None when the problem is too small."""
        n_kf = len(self.keyframe_poses)
        n_pts = len(self.world_points)
        if n_kf < 2 or n_pts < 8 or len(self.observations) < 24:
            return None
        obs = np.array(self.observations)
        counts = np.bincount(obs[:, 1].astype(np.int64), minlength=n_pts)
        keep = counts >= 2
        remap = np.full(n_pts, -1, np.int64)
        remap[keep] = np.arange(keep.sum())
        obs = obs[keep[obs[:, 1].astype(np.int64)]]
        if len(obs) < 24 or keep.sum() < 8:
            return None
        frame_idx = obs[:, 0].astype(np.int64)
        point_idx = remap[obs[:, 1].astype(np.int64)]
        uv = obs[:, 2:4].astype(np.float32)
        pts = np.stack(self.world_points)[keep]
        bao = bundle.build_observations(frame_idx, point_idx, uv, int(keep.sum()), device=self.device)
        T_cw = np.stack([np.linalg.inv(p) for p in self.keyframe_poses]).astype(np.float32)
        problem = bundle.BAProblem(torch.from_numpy(T_cw).to(self.device), torch.from_numpy(pts).to(self.device),
                                   bao)
        cam = self.camera
        opt, mse = bundle.optimize(problem, cam.fx, cam.fy, cam.cx, cam.cy, max_iters=max_iters)
        T_cw_new = opt.poses.cpu().numpy()
        self.keyframe_poses = [np.linalg.inv(T_cw_new[i]).astype(np.float32) for i in range(n_kf)]
        pts_new = opt.points.cpu().numpy()
        for local, gid in enumerate(np.nonzero(keep)[0]):
            self.world_points[gid] = pts_new[local]
        self.state.update_all_poses(np.stack(self.keyframe_poses))
        return mse
