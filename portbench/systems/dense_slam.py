"""The program's side of the DenseFusion configuration: one scan of
`onepiece_tpu_torch.systems.dense_slam.DenseSlam`, as
`tools/torch_dense_fusion.py` runs it.

A scan is a fresh system. `feed` hands the frames of a chunk to
`update_frame` one by one, in order (dense tracking; at a submap's last
frame its cloud, features, ICP, the global registrations and the pose
graph); the scan ends with `reconstruct`, DenseFusion's post-hoc TSDF
volume of every 8th frame at the optimised poses and its mesh, on the
card, and no file. Besides what a user gets, the output keeps the state
that the judge checks stage by stage: each frame's pose in its submap, the
submap clouds and features, the edges, and the submap poses before and
after each pose-graph solve (read before and after the frame that
finishes a submap).
"""

from __future__ import annotations

import numpy as np
import torch

from onepiece_tpu_torch.geometry.camera import PinholeCamera
from onepiece_tpu_torch.systems.dense_slam import DenseSlam, reconstruct

from ..reference.dense_slam import SlamOut
from ..reference.registration import Cloud, Features


class Scan:
    def __init__(self, cfg: dict, device: torch.device):
        c = cfg["camera"]
        self.cfg = cfg
        self.device = device
        self.cam = PinholeCamera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"], c["depth_scale"])
        self.slam = DenseSlam(self.cam, device, submap_size=cfg["submap_size"], voxel_size=cfg["voxel_size"],
                              icp_threshold=cfg["icp_threshold"])
        self.kept: list = []  # (index, depth, rgb) of the frames the reconstruction fuses: views, no copy
        self.solves: list = []

    def feed(self, grays, depths, rgbs) -> None:
        slam = self.slam
        for g, d, c in zip(grays, depths, rgbs):
            i = slam.frame_count
            finishes = (i + 1) % slam.submap_size == 0 and i >= slam.submap_size  # a submap after the first
            if finishes:
                before = np.stack(slam.submap_poses)
            slam.update_frame(g, d)
            if finishes:
                self.solves.append((before, len(slam.edges), np.stack(slam.submap_poses)))
            if i % self.cfg["posthoc_stride"] == 0:
                self.kept.append((i, d, c))

    def grow(self) -> bool:
        return False  # DenseSlam keeps no pool while it tracks

    def finish(self) -> SlamOut:
        slam = self.slam
        poses = slam.trajectory()
        vol, (v, f, c) = reconstruct(poses, self.kept, self.cam, self.cfg["posthoc_voxel"], self.device)
        na = vol.num_active
        coords = torch.from_numpy(vol.block_coords[:na]).to(vol.device, torch.int32)
        return SlamOut(
            torch.from_numpy(poses).to(self.device),
            torch.from_numpy(np.stack([m["T_ts"] for m in slam.metrics])).to(self.device),
            torch.from_numpy(np.stack(slam.rel_in_submap)).to(self.device),
            slam.submap_size, [Cloud(x.points, x.normals, x.colors, x.valid) for x in slam.submap_clouds],
            [Features(*x) for x in slam.submap_features], slam.edges, self.solves, vol.vox, coords, v, f, c)
