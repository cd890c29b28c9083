"""The program's side of the BAFusion configuration: one scan of
`onepiece_tpu_torch.systems.fused_ba.FusedBASlam`, as a user runs it.

A scan is a fresh system. Chunks go through `process_chunk` (the sparse
front end, loop closure, the pose graph, the track linker and BA, one
fetch a chunk); the scan ends with `trajectory()`. The keyframes, edges and
world points stay on the device, as references that the judge reads after
the window.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from onepiece_tpu_torch.geometry.camera import PinholeCamera
from onepiece_tpu_torch.systems.fused_ba import FusedBASlam


class BAOut(NamedTuple):
    trajectory: torch.Tensor  # (N, 4, 4) world-from-camera, host
    kf_pose: torch.Tensor  # (N_CAP, 4, 4) world-from-keyframe
    num_kf: int
    edge_src: torch.Tensor  # (E_CAP,) int64
    edge_dst: torch.Tensor
    num_edges: int
    lc_edges: int
    pt_local: torch.Tensor  # (P_CAP, 3) birth-keyframe coordinates
    pt_anchor: torch.Tensor  # (P_CAP,) birth keyframe
    n_pts: int
    ba_mse: float  # BA's mean squared error after the last chunk's LM steps


def settings(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("max_keypoints", "fast_threshold", "keyframe_disparity", "num_hypotheses",
                                "kf_capacity", "edge_capacity", "corr_capacity", "pt_capacity", "obs_capacity",
                                "ba_iters", "ba_lam0", "ba_every_chunks", "residual")}


def outputs(slam) -> BAOut:
    st, ts = slam._state, slam._track_state
    return BAOut(torch.from_numpy(slam.trajectory()), st.kf_pose, slam.num_kf, st.edges.src, st.edges.dst,
                 slam.num_edges, slam.lc_edges_total, ts.pt_local, ts.pt_anchor, slam.n_pts, slam.ba_mse)


class Scan:
    def __init__(self, cfg: dict, device: torch.device):
        c = cfg["camera"]
        cam = PinholeCamera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"], c["depth_scale"])
        self.slam = FusedBASlam(cam, device=device, **settings(cfg))

    def feed(self, grays, depths, rgbs) -> None:
        self.slam.process_chunk(grays, depths)

    def grow(self) -> bool:
        return False  # the system grows its capacities inside `process_chunk`

    def finish(self) -> BAOut:
        return outputs(self.slam)
