"""The port's sparse tracking (`odometry/sparse.py`, `ops/ransac.py`'s
depth-normalised gate) against the JAX package, on the CPU.

The two packages draw different random numbers, so the JAX package's
draws (its RanSaPC anchors per round and both RANSAC sample sets, taken
with its own keys on its own intermediate masks) are handed to the port.
Tolerances: T within 1e-5 (the refit's SVD and the hypotheses' power
iteration round differently), inlier counts and correspondence masks
equal, matched indices and points equal on the valid correspondences
(invalid keypoints carry descriptors of no meaning in both packages).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.odometry import sparse as jsparse
from onepiece_tpu.ops import hamming as jham
from onepiece_tpu.ops import ransac as jransac
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.odometry import sparse as tsparse
from onepiece_tpu_torch.ops import ransac as transac
from onepiece_tpu_torch.utils import synthetic

CAM = TUM_CAMERA.pyramid(3)[2]  # 160x120
JCAM160 = JCAM.next_pyramid_level().next_pyramid_level()
HYP = 256


@pytest.fixture(scope="module")
def frames():
    """Frames 0 and 3 of the orbit, extracted by both packages."""
    poses = synthetic.orbit_trajectory(12)
    scene = synthetic.default_scene()
    out = [synthetic.render(scene, torch.from_numpy(poses[i]), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                            CAM.height, CAM.width, num_steps=64) for i in (0, 3)]
    grays = np.stack([o[1].numpy() for o in out])
    depths = np.stack([o[0].numpy() for o in out])
    fj = jsparse.extract_sparse_frames_batch(jnp.asarray(grays), jnp.asarray(depths), JCAM160,
                                             max_keypoints=500, threshold=0.01)
    ft = tsparse.extract_sparse_frames_batch(torch.from_numpy(grays), torch.from_numpy(depths), CAM,
                                             max_keypoints=500, threshold=0.01)
    return fj, ft


def _jax_draws(key, src, tgt):
    """The draws the JAX package's `_match_and_estimate` makes, as the port's Draws."""
    keys = jax.random.split(key, jsparse.RANSAPC_ROUNDS + 2)
    idx, ok = jham.match_descriptors(src.kp.desc, src.valid, tgt.kp.desc, tgt.valid)
    dst = tgt.points[idx]
    ok = ok & tgt.valid[idx]
    anchors = []
    for r in range(jsparse.RANSAPC_ROUNDS):
        anchors.append(np.asarray(jransac._sample_indices(keys[r], ok, 1, 8)[0]))
        ok = jransac.ransapc_filter(keys[r], src.points, dst, ok)
    round1 = np.asarray(jransac._sample_indices(keys[-2], ok, HYP, jsparse.RANSAC_SAMPLES))
    res1 = jransac.ransac_rigid(keys[-2], src.points, dst, ok, threshold=jsparse.RANSAC_THRESHOLD,
                                num_hypotheses=HYP, sample_size=jsparse.RANSAC_SAMPLES, norm_z=src.points[:, 2])
    uv_pred, _ = JCAM160.project(src.points @ res1.T[:3, :3].T + res1.T[:3, 3])
    idx2, ok2 = jham.match_descriptors_windowed(src.kp.desc, src.valid, tgt.kp.desc, tgt.valid, uv_pred, tgt.kp.uv)
    round2 = np.asarray(jransac._sample_indices(keys[-1], ok2 & tgt.valid[idx2], HYP, jsparse.RANSAC_SAMPLES))
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int64))  # noqa: E731
    return tsparse.Draws(as_t(np.stack(anchors)), as_t(round1), as_t(round2)), int(res1.num_inliers)


@pytest.mark.parametrize("rematch", ["always", "gate_runs", "gate_skips"])
def test_match_and_estimate_with_jax_draws(frames, rematch):
    fj, ft = frames
    src, tgt = (jax.tree.map(lambda a: a[i], fj) for i in (0, 1))
    src_t, tgt_t = (tsparse.map_frame(lambda a: a[i], ft) for i in (0, 1))
    key = jax.random.PRNGKey(5)
    draws, n1 = _jax_draws(key, src, tgt)
    rematch_below = {"always": None, "gate_runs": n1 + 1, "gate_skips": n1}[rematch]
    rj, sj = jsparse._track_summary_inner(key, src, tgt, JCAM160, HYP, rematch_below)
    rt, st = tsparse._track_summary_inner(None, src_t, tgt_t, CAM, HYP, rematch_below, draws)
    assert int(rj.num_inliers) >= tsparse.MIN_INLIERS and bool(st.success) == bool(sj.success)
    assert int(rt.num_inliers) == int(rj.num_inliers)
    assert np.abs(rt.T_ts.numpy() - np.asarray(rj.T_ts)).max() < 1e-5
    v = np.asarray(rj.corr_valid)
    assert np.array_equal(rt.corr_valid.numpy(), v)
    assert np.array_equal(rt.corr_idx.numpy()[v], np.asarray(rj.corr_idx)[v])
    assert np.array_equal(rt.corr_dst.numpy()[v], np.asarray(rj.corr_dst)[v])
    assert abs(float(st.rmse) - float(sj.rmse)) < 1e-5 * max(1.0, float(sj.rmse))
    assert abs(float(st.disparity) - float(sj.disparity)) < 1e-3


def test_ransac_rigid_depth_normalised_gate_matches_jax():
    rng = np.random.default_rng(3)
    src = rng.uniform([-1, -1, 0.5], [1, 1, 4.0], (400, 3)).astype(np.float32)
    a = 0.3
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    dst = (src @ R.T + np.float32([0.1, -0.2, 0.05])).astype(np.float32)
    dst += (rng.normal(size=dst.shape) * 0.002 * src[:, 2:]).astype(np.float32)  # depth-growing noise
    out = rng.random(400) < 0.3
    dst[out] += rng.normal(size=(out.sum(), 3)).astype(np.float32) * 0.3
    valid = rng.random(400) > 0.05
    key = jax.random.PRNGKey(1)
    hyp = np.asarray(jransac._sample_indices(key, jnp.asarray(valid), 128, 8))
    rj = jransac.ransac_rigid(key, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), threshold=0.01,
                              num_hypotheses=128, sample_size=8, norm_z=jnp.asarray(src[:, 2]))
    rt = transac.ransac_rigid(None, torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
                              threshold=0.01, num_hypotheses=128, sample_size=8,
                              samples=torch.from_numpy(hyp.astype(np.int64)), norm_z=torch.from_numpy(src[:, 2]))
    assert int(rt.num_inliers) == int(rj.num_inliers) > 150
    assert np.array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert np.abs(rt.T.numpy() - np.asarray(rj.T)).max() < 1e-5
    assert abs(float(rt.rmse) - float(rj.rmse)) < 1e-6


def test_ransapc_defaults_match_jax():
    import inspect

    p = inspect.signature(jransac.ransapc_filter).parameters
    assert (transac.RANSAPC_ANCHORS, transac.RANSAPC_TOLERANCE, transac.RANSAPC_MIN_VOTES) == (
        p["num_anchors"].default, p["tolerance"].default, p["min_votes"].default)
    assert inspect.signature(transac.ransapc_filter).parameters["tolerance"].default == 0.1


def test_se3_inverse_matches_jax():
    T = synthetic.orbit_trajectory(5)[3].astype(np.float32)
    assert np.abs(tsparse.se3_inverse(torch.from_numpy(T)).numpy() - np.asarray(jsparse.se3_inverse(T))).max() < 1e-7
