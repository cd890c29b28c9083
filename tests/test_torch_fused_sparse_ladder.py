"""The failure ladder of the port's FusedFBASlam (`systems/fused_sparse.py`),
on the CPU, the port alone at 160x120 (500 keypoints, keyframe disparity 10
px, one chunk).

The counterparts of `tests/test_fused_sparse.py`'s
`test_fused_sparse_midchunk_failure_recovery` and
`test_fused_sparse_rebase_after_persistent_failure`, with their blanked
frames and their bounds:

- Mid-chunk failure: frames 5-6 of a slow 12-frame orbit are blanked; the
  frames after the blackout must line up with the ground truth again (ATE
  over the surviving frames < 0.05 m), and only the blank frames may fail.
  Here frame 7 tracks against the current keyframe again, so no rung
  recovers a frame: the chunk's `relocs` and `retro` are 0, as the JAX
  package's are on this input.
- Persistent failure: frames 4-8 of the 14-frame orbit are blanked, so the
  failure streak passes REBASE_AFTER and rung C re-bootstraps a keyframe at
  the carried pose (a keyframe whose frame did not track, in the host's `ok`
  and keyframe records) on the first frame after the gap; the relative
  translation from frame 10 to 13 is within 0.03 m of the ground truth's.

Rungs A and B are shown to recover frames on inputs of their own, frames
of the same 14-frame orbit, each with the 0.05 m ATE bound over every
frame:

- Rung A (re-track against the previous frame, which is promoted): with the
  keyframe trigger off (disparity 1e9), tracking against keyframe 0 fails
  as the camera moves away (frames 0-6): `retro` > 0.
- Rung B (relocalise against the best MILD candidate): frames 0, 2, ...,
  12, then frame 3, far from the current keyframe and from the previous
  frame: `relocs` > 0.

Blanked frames are not rendered.

Torch is pinned to one intra-op thread while the module runs.
"""

import numpy as np
import pytest
import torch

from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.systems import fused_sparse as fs
from onepiece_tpu_torch.utils import synthetic

CAM = TUM_CAMERA.pyramid(3)[2]  # 160x120
SETTINGS = dict(max_keypoints=500, keyframe_disparity=10.0, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def render(poses: np.ndarray, blank=()) -> tuple[torch.Tensor, torch.Tensor]:
    """(grays, depths) of the poses; the frames in `blank` all zeros."""
    scene = synthetic.default_scene()
    out = [synthetic.render(scene, torch.from_numpy(p), CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.height, CAM.width,
                            num_steps=64) if i not in blank else (torch.zeros(CAM.height, CAM.width),) * 2
           for i, p in enumerate(poses)]
    return torch.stack([g for _, g in out]), torch.stack([d for d, _ in out])


@pytest.fixture(scope="module")
def orbit14():
    poses = synthetic.orbit_trajectory(14)
    return (poses, *render(poses))


def run(grays, depths, **settings):
    """FusedFBASlam over the frames, one chunk."""
    slam = fs.FusedFBASlam(CAM, **{**SETTINGS, **settings})
    info = slam.process_chunk(grays, depths)
    return slam, slam.trajectory(), info


def test_fused_sparse_midchunk_failure_recovery():
    poses = synthetic.orbit_trajectory(24)[:12]  # slow motion: the post-blackout view overlaps the keyframes
    slam, est, info = run(*render(poses, blank=(5, 6)))
    ok_frames = [i for i in range(12) if i not in (5, 6)]
    ate = traj.ate_rmse(est[ok_frames], poses[ok_frames])
    assert ate < 0.05, (ate, info)
    assert slam._ok == [i not in (5, 6) for i in range(12)], (slam._ok, info)


def test_fused_sparse_rebase_after_persistent_failure(orbit14):
    poses, grays, depths = orbit14
    grays, depths = grays.clone(), depths.clone()
    grays[4:9] = 0.0
    depths[4:9] = 0.0
    slam, est, info = run(grays, depths)
    assert slam.num_kf >= 3, info
    rebased = [i for i in range(14) if slam._iskf[i] and not slam._ok[i]]
    assert rebased == [9], (slam._ok, slam._iskf)
    rel_est = np.linalg.inv(est[10]) @ est[13]
    rel_gt = np.linalg.inv(poses[10]) @ poses[13]
    err = np.linalg.norm(rel_est[:3, 3] - rel_gt[:3, 3])
    assert err < 0.03, (err, info)


def test_rung_a_retro_promotes_the_previous_frame(orbit14):
    poses, grays, depths = orbit14
    slam, est, info = run(grays[:7], depths[:7], keyframe_disparity=1e9)
    assert info["retro"] > 0 and all(slam._ok), (info, slam._ok)
    assert traj.ate_rmse(est, poses[:7]) < 0.05, info


def test_rung_b_relocalises_a_revisit(orbit14):
    poses, grays, depths = orbit14
    idx = [0, 2, 4, 6, 8, 10, 12, 3]
    slam, est, info = run(grays[idx], depths[idx])
    assert info["relocs"] > 0 and all(slam._ok), (info, slam._ok)
    assert traj.ate_rmse(est, poses[idx]) < 0.05, info
