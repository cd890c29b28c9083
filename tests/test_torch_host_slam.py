"""The port's host-loop systems (`systems/{keyframe_slam,fbaslam,baslam}.py`)
against the JAX package's, on the CPU (plain versions).

Settings of `tests/test_systems.py`: 160x120 (fx = fy = 100), FAST
threshold 0.03, keyframe disparity 10 px, on the first 10 frames of its
14-frame synthetic orbit, rendered once for the module. The two packages
draw different random numbers, so the systems are held to the JAX runs'
accuracy regime, as
`tests/test_torch_fused_sparse.py` holds FusedFBASlam: ATE < max(3 x the
JAX ATE, 0.05 m), keyframes within 2 of the JAX run's, at least one edge
(FBASlam) or linked track (BASlam) a keyframe. The bookkeeping
(`KeyframeSlamState`, `average_disparity`) and the track linker
(`BASlam._link_tracks`, fed the same tracking results) are held equal:
world points within 1e-6, track maps and observations equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry.camera import PinholeCamera as JCam
from onepiece_tpu.odometry import sparse as jsparse
from onepiece_tpu.systems import keyframe_slam as jks
from onepiece_tpu.systems.baslam import BASlam as JBASlam
from onepiece_tpu.systems.fbaslam import FBASlam as JFBASlam
from onepiece_tpu_torch.geometry.camera import PinholeCamera
from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.systems import keyframe_slam as tks
from onepiece_tpu_torch.systems.baslam import BASlam
from onepiece_tpu_torch.systems.fbaslam import FBASlam

_CAM = dict(fx=100.0, fy=100.0, cx=79.5, cy=59.5, width=160, height=120, depth_scale=1000.0)
CAM, JCAM = PinholeCamera(**_CAM), JCam(**_CAM)
SETTINGS = dict(fast_threshold=0.03, keyframe_disparity=10.0)
N_FRAMES = 10
SPLIT = 6  # process_chunk runs frames [0, 6) then [6, 10)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs (the test workers share the
    host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def seq():
    from onepiece_tpu_torch.utils import synthetic

    poses = synthetic.orbit_trajectory(14)[:N_FRAMES]  # tests/test_systems.py's orbit, cut
    scene = synthetic.default_scene()
    out = [synthetic.render(scene, torch.from_numpy(p), CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.height, CAM.width,
                            num_steps=64) for p in poses]
    return np.stack([o[1].numpy() for o in out]), np.stack([o[0].numpy() for o in out]), poses


def _run(slam, grays, depths, mode):
    if mode == "update_frame":
        for g, d in zip(grays, depths):
            assert slam.update_frame(g, d)["success"]
    else:
        slam.process_chunk(grays[:SPLIT], depths[:SPLIT])
        slam.process_chunk(grays[SPLIT:], depths[SPLIT:])
    return slam


@pytest.mark.parametrize("system,mode", [
    ("FBASlam", "update_frame"),
    pytest.param("FBASlam", "process_chunk", marks=pytest.mark.slow),
    pytest.param("BASlam", "update_frame", marks=pytest.mark.slow),
    pytest.param("BASlam", "process_chunk", marks=pytest.mark.slow),
])
def test_host_loop_system_in_the_jax_regime(seq, system, mode):
    grays, depths, poses = seq
    port_cls, jax_cls = {"FBASlam": (FBASlam, JFBASlam), "BASlam": (BASlam, JBASlam)}[system]
    jax_slam = _run(jax_cls(JCAM, **SETTINGS), grays, depths, mode)
    port = _run(port_cls(CAM, device="cpu", **SETTINGS), grays, depths, mode)
    est = port.trajectory()
    assert est.shape == (N_FRAMES, 4, 4) and np.isfinite(est).all()
    ate_j = traj.ate_rmse(jax_slam.trajectory(), poses)
    ate_t = traj.ate_rmse(est, poses)
    assert ate_t < max(3.0 * ate_j, 0.05), (ate_t, ate_j)
    n_kf, n_kf_j = len(port.keyframe_frames), len(jax_slam.keyframe_frames)
    assert n_kf >= 2 and abs(n_kf - n_kf_j) <= 2, (n_kf, n_kf_j)
    assert len(port.keyframe_poses) == n_kf == len(port.state.keyframe_ids)
    if system == "FBASlam":
        assert len(port.edges) >= n_kf - 1
        assert all(e["p_src"].dtype == np.float32 and len(e["p_src"]) <= 256 for e in port.edges)
    else:
        # every keyframe observes linked tracks, and BA ran to a finite error
        assert {o[0] for o in port.observations} == set(range(n_kf))
        assert len(port.world_points) > 20 and len(port.track_of_kp) == n_kf
        mse = port.optimize()
        assert mse is not None and np.isfinite(mse) and mse < 25.0


@pytest.mark.parametrize("system,mode", [("FBASlam", "process_chunk"), ("BASlam", "update_frame"),
                                         ("BASlam", "process_chunk")])
def test_host_loop_mode_on_its_own(seq, system, mode):
    """The quick tier's cover of the three JAX-regime cases under `slow`:
    the port alone, held to `tests/test_systems.py`'s bars for the JAX
    package (ATE < 0.06 m for FBASlam, < 0.15 m for BASlam), with the same
    keyframe, edge and track checks, and for BASlam a finite final BA."""
    grays, depths, poses = seq
    port = _run({"FBASlam": FBASlam, "BASlam": BASlam}[system](CAM, device="cpu", **SETTINGS), grays, depths, mode)
    est = port.trajectory()
    assert est.shape == (N_FRAMES, 4, 4) and np.isfinite(est).all()
    assert traj.ate_rmse(est, poses) < (0.06 if system == "FBASlam" else 0.15)
    n_kf = len(port.keyframe_frames)
    assert n_kf >= 2 and len(port.state.keyframe_ids) == n_kf
    if system == "FBASlam":
        assert len(port.edges) >= n_kf - 1
    else:
        assert {o[0] for o in port.observations} == set(range(n_kf)) and len(port.world_points) > 20
        mse = port.optimize()
        assert mse is not None and np.isfinite(mse) and mse < 25.0


def test_keyframe_slam_state_matches_jax():
    rng = np.random.default_rng(5)
    from onepiece_tpu_torch.geometry import se3

    T = se3.se3_exp(torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32) * 0.3)).numpy()
    a, b = tks.KeyframeSlamState(CAM), jks.KeyframeSlamState(JCAM)
    anchors = [0, 0, 1, 1, 1, 2, 2, 0, 2]
    for i, k in enumerate(anchors):
        for s in (a, b):
            s.add_frame(T[i], k, T[(i + 3) % 9], i != 4)
            if i in (0, 2, 5):
                s.promote_keyframe(i)
    kf = T[6:9]
    a.update_all_poses(kf)
    b.update_all_poses(kf)
    assert np.array_equal(a.trajectory(), b.trajectory())
    assert (a.keyframe_ids, a.anchor_keyframe, a.tracking_success) == (b.keyframe_ids, b.anchor_keyframe,
                                                                        b.tracking_success)
    assert tks.KEYFRAME_DISPARITY == jks.KEYFRAME_DISPARITY
    assert tks.KeyframeSlamState(CAM).trajectory().shape == jks.KeyframeSlamState(JCAM).trajectory().shape
    uv_a = rng.uniform(0, 160, (50, 2)).astype(np.float32)
    uv_b = uv_a + rng.normal(size=(50, 2)).astype(np.float32) * 4
    for valid in (rng.random(50) > 0.3, np.zeros(50, bool)):
        assert tks.average_disparity(uv_a, uv_b, valid) == jks.average_disparity(uv_a, uv_b, valid)


def test_link_tracks_matches_jax(seq):
    """Three keyframes (frames 0, 2, 4) linked 0 -> 2, 2 -> 4, then the
    pair 0 -> 4 (which meets tracks of both), from the JAX package's
    tracking results, in both packages' BASlam."""
    grays, depths, poses = seq
    jf = jsparse.extract_sparse_frames_batch(jnp.asarray(grays[[0, 2, 4]]), jnp.asarray(depths[[0, 2, 4]]), JCAM,
                                             max_keypoints=1000, threshold=0.03)
    frames = [jax.tree.map(lambda a: a[i], jf) for i in range(3)]
    kf_poses = [np.linalg.inv(poses[0]) @ poses[i] for i in (0, 2, 4)]
    jslam, tslam = JBASlam(JCAM), BASlam(CAM, device="cpu")
    for s in (jslam, tslam):
        s.keyframe_poses = [p.astype(np.float32) for p in kf_poses]
        s.track_of_kp = [np.full(1000, -1, np.int64) for _ in range(3)]
    jslam.keyframe_frames = frames
    tslam.keyframe_uv = [np.asarray(f.kp.uv) for f in frames]
    for n, (s, t) in enumerate([(0, 1), (1, 2), (0, 2)]):
        res, _ = jsparse.sparse_tracking_with_summary(frames[s], frames[t], JCAM, jax.random.PRNGKey(n))
        host = types.SimpleNamespace(corr_src=np.asarray(res.corr_src), corr_valid=np.asarray(res.corr_valid),
                                     corr_idx=np.asarray(res.corr_idx))
        assert tslam._link_tracks(s, t, host) == jslam._link_tracks(s, t, res) > 10
    assert len(tslam.world_points) == len(jslam.world_points)
    assert np.abs(np.stack(tslam.world_points) - np.stack(jslam.world_points)).max() <= 1e-6
    assert all(np.array_equal(a, b) for a, b in zip(tslam.track_of_kp, jslam.track_of_kp))
    assert tslam.observations == jslam.observations


def test_link_tracks_colocated_keypoints():
    """`tests/test_systems.py`'s BASlam(max_keypoints=4) case: two target
    keypoints at the SAME 3-D point link unambiguously, since the match
    index is carried in the tracking result (corr_idx)."""
    slam = BASlam(CAM, max_keypoints=4, device="cpu")
    uv_src = np.array([[10, 10], [20, 20], [30, 30], [40, 40]], np.float32)
    pts = np.array([[0.1, 0.1, 1.0], [0.5, 0.5, 2.0], [0.5, 0.5, 2.0], [0.9, 0.1, 1.5]], np.float32)
    uv_dst = np.array([[11, 10], [21, 20], [22, 21], [41, 40]], np.float32)
    slam.keyframe_uv = [uv_src, uv_dst]
    slam.keyframe_poses = [np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)]
    slam.track_of_kp = [np.full(4, -1, np.int64), np.full(4, -1, np.int64)]
    res = types.SimpleNamespace(corr_src=pts, corr_valid=np.ones(4, bool), corr_idx=np.array([0, 2, 1, 3]))
    assert slam._link_tracks(0, 1, res) == 4
    src_tracks, dst_tracks = slam.track_of_kp
    assert src_tracks[1] == dst_tracks[2] and src_tracks[2] == dst_tracks[1]
    assert len(set(src_tracks.tolist())) == 4
    assert len(slam.observations) == 8 and (1, int(dst_tracks[2]), 22.0, 21.0) in slam.observations


def test_host_loop_defaults_match_jax():
    import inspect

    for tcls, jcls in ((FBASlam, JFBASlam), (BASlam, JBASlam)):
        p = inspect.signature(jcls).parameters
        q = inspect.signature(tcls).parameters
        assert {k: v.default for k, v in p.items()} == {k: v.default for k, v in q.items() if k != "device"}
        assert q["device"].default == "cuda"
