"""Keyframe-based SLAM bookkeeping of the host-loop systems.

Port of `onepiece_tpu/systems/keyframe_slam.py` (numpy, as there): per-frame
world poses, the keyframes, and the anchoring rule that re-bases every frame
on its keyframe after an optimisation (ref: KeyframeBasedSlam.h:15-61,
`UpdateAllPoses` :36-45).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..geometry.camera import PinholeCamera

# the reference's keyframe trigger: average feature disparity >= 30 px
# (ref: FBASlam.cpp:36-37, Correspondence.h:22-40)
KEYFRAME_DISPARITY = 30.0


@dataclasses.dataclass
class KeyframeSlamState:
    camera: PinholeCamera
    poses: list = dataclasses.field(default_factory=list)  # (4, 4) world-from-frame, per frame
    keyframe_ids: list = dataclasses.field(default_factory=list)  # frame indices
    anchor_keyframe: list = dataclasses.field(default_factory=list)  # per frame: index into keyframe_ids
    relative_to_anchor: list = dataclasses.field(default_factory=list)  # per frame: T_kf_frame
    tracking_success: list = dataclasses.field(default_factory=list)

    def add_frame(self, T_world: np.ndarray, kf_index: int, T_rel: np.ndarray, success: bool):
        self.poses.append(np.asarray(T_world))
        self.anchor_keyframe.append(kf_index)
        self.relative_to_anchor.append(np.asarray(T_rel))
        self.tracking_success.append(success)

    def promote_keyframe(self, frame_idx: int):
        self.keyframe_ids.append(frame_idx)

    def update_all_poses(self, keyframe_poses: np.ndarray):
        """Re-anchor every frame to its keyframe's optimised pose;
        keyframe_poses (num_keyframes, 4, 4) world-from-keyframe."""
        for i in range(len(self.poses)):
            k = self.anchor_keyframe[i]
            self.poses[i] = keyframe_poses[k] @ self.relative_to_anchor[i]

    def trajectory(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))


def average_disparity(uv_a: np.ndarray, uv_b: np.ndarray, valid: np.ndarray) -> float:
    """Mean pixel displacement between matched keypoints (ref:
    Correspondence.h:22-40 `CalculateAverageDisparity`); inf without a match."""
    if valid.sum() == 0:
        return float("inf")
    d = np.linalg.norm(uv_a[valid] - uv_b[valid], axis=-1)
    return float(d.mean())
