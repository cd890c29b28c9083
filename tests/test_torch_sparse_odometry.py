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

from onepiece_tpu.systems.fbaslam import FBASlam as JFBASlam

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


def _jax_draws(key, src, tgt, hyp=HYP):
    """The draws the JAX package's `_match_and_estimate` makes with `hyp`
    hypotheses, as the port's Draws."""
    keys = jax.random.split(key, jsparse.RANSAPC_ROUNDS + 2)
    idx, ok = jham.match_descriptors(src.kp.desc, src.valid, tgt.kp.desc, tgt.valid)
    dst = tgt.points[idx]
    ok = ok & tgt.valid[idx]
    anchors = []
    for r in range(jsparse.RANSAPC_ROUNDS):
        anchors.append(np.asarray(jransac._sample_indices(keys[r], ok, 1, 8)[0]))
        ok = jransac.ransapc_filter(keys[r], src.points, dst, ok)
    round1 = np.asarray(jransac._sample_indices(keys[-2], ok, hyp, jsparse.RANSAC_SAMPLES))
    res1 = jransac.ransac_rigid(keys[-2], src.points, dst, ok, threshold=jsparse.RANSAC_THRESHOLD,
                                num_hypotheses=hyp, sample_size=jsparse.RANSAC_SAMPLES, norm_z=src.points[:, 2])
    uv_pred, _ = JCAM160.project(src.points @ res1.T[:3, :3].T + res1.T[:3, 3])
    idx2, ok2 = jham.match_descriptors_windowed(src.kp.desc, src.valid, tgt.kp.desc, tgt.valid, uv_pred, tgt.kp.uv)
    round2 = np.asarray(jransac._sample_indices(keys[-1], ok2 & tgt.valid[idx2], hyp, jsparse.RANSAC_SAMPLES))
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


@pytest.mark.parametrize("gate", ["fixed", "depth"])
def test_ransac_rigid_on_the_cpu_takes_the_plain_route(gate):
    """On CPU tensors `ransac_rigid` runs the plain route: no kernel launch,
    no `ransac.kernel` count, its `.score` and `.refit` spans, and the plain
    route's result on the same draw bit for bit, within 1e-5 of the JAX
    package's on that draw."""
    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.utils import tracing

    rng = np.random.default_rng(12)
    src = rng.uniform([-1, -1, 0.5], [1, 1, 4.0], (300, 3)).astype(np.float32)
    dst = (src + np.float32([0.1, -0.2, 0.05]) + rng.normal(size=src.shape) * 0.002).astype(np.float32)
    out = rng.random(300) < 0.3
    dst[out] += rng.normal(size=(out.sum(), 3)).astype(np.float32) * 0.3
    valid = rng.random(300) > 0.05
    src_t, dst_t, valid_t = torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid)
    z = src_t[:, 2] if gate == "depth" else None
    key = jax.random.PRNGKey(4)
    samples = torch.from_numpy(np.asarray(jransac._sample_indices(key, jnp.asarray(valid), 64, 8)).astype(np.int64))
    _build.reset_launch_counts()
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("sparse.track"):
            res = transac.ransac_rigid(None, src_t, dst_t, valid_t, threshold=0.01, num_hypotheses=64,
                                       sample_size=8, samples=samples, norm_z=z)
    names = {sp.name for sp in tracing.spans()}
    assert _build.RANSAC_RIGID.launches == 0 and "ransac.kernel" not in tracing.counters()
    assert {"sparse.hypotheses", "sparse.score", "sparse.refit"} <= names and "sparse.fit" not in names
    tracing.clear()
    ref = transac.ransac_rigid_reference(src_t, dst_t, valid_t, 0.01, samples, z)
    for a, b in zip(res, ref):
        assert torch.equal(a, b)
    rj = jransac.ransac_rigid(key, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), threshold=0.01,
                              num_hypotheses=64, sample_size=8, norm_z=None if z is None else jnp.asarray(src[:, 2]))
    assert int(res.num_inliers) == int(rj.num_inliers) > 100
    assert np.array_equal(res.inliers.numpy(), np.asarray(rj.inliers))
    assert np.abs(res.T.numpy() - np.asarray(rj.T)).max() < 1e-5


def test_ransapc_defaults_match_jax():
    import inspect

    p = inspect.signature(jransac.ransapc_filter).parameters
    assert (transac.RANSAPC_ANCHORS, transac.RANSAPC_TOLERANCE, transac.RANSAPC_MIN_VOTES) == (
        p["num_anchors"].default, p["tolerance"].default, p["min_votes"].default)
    assert inspect.signature(transac.ransapc_filter).parameters["tolerance"].default == 0.1


def test_se3_inverse_matches_jax():
    T = synthetic.orbit_trajectory(5)[3].astype(np.float32)
    assert np.abs(tsparse.se3_inverse(torch.from_numpy(T)).numpy() - np.asarray(jsparse.se3_inverse(T))).max() < 1e-7


# ---- the host-loop systems' tracking entry points ---------------------------

SCAN_FRAMES = 7  # the keyframe, then a chunk of 6
SCAN_DISPARITY = 10.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs (the test workers share the
    host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def orbit7():
    """Frames 0-6 of the 12-frame orbit at 160x120, extracted by both
    packages (500 keypoints, FAST threshold 0.01)."""
    poses = synthetic.orbit_trajectory(12)
    scene = synthetic.default_scene()
    out = [synthetic.render(scene, torch.from_numpy(poses[i]), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                            CAM.height, CAM.width, num_steps=64) for i in range(SCAN_FRAMES)]
    grays = np.stack([o[1].numpy() for o in out])
    depths = np.stack([o[0].numpy() for o in out])
    fj = jsparse.extract_sparse_frames_batch(jnp.asarray(grays), jnp.asarray(depths), JCAM160,
                                             max_keypoints=500, threshold=0.01)
    ft = tsparse.extract_sparse_frames_batch(torch.from_numpy(grays), torch.from_numpy(depths), CAM,
                                             max_keypoints=500, threshold=0.01)
    return grays, depths, fj, ft


def test_single_frame_extractor_matches_jax():
    """The port's `extract_sparse_frame` (the batch path on one frame: the
    batch blur, a stable sort) against the JAX package's single-frame
    function (`features.detect_and_describe`: `image_ops.gaussian_blur`, an
    exact `lax.top_k`), at the host-loop systems' settings."""
    cam_j = JCAM160
    poses = synthetic.orbit_trajectory(10)
    scene = synthetic.default_scene()
    for i in (0, 4, 9):
        d, g = synthetic.render(scene, torch.from_numpy(poses[i]), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                                CAM.height, CAM.width, num_steps=64)
        for threshold in (0.03, 0.01):
            fj = jsparse.extract_sparse_frame(jnp.asarray(g.numpy()), jnp.asarray(d.numpy()), cam_j,
                                              max_keypoints=1000, threshold=threshold)
            ft = tsparse.extract_sparse_frame(g, d, CAM, max_keypoints=1000, threshold=threshold)
            v = np.asarray(fj.kp.valid)
            assert v.sum() > 50
            assert np.array_equal(ft.kp.uv.numpy(), np.asarray(fj.kp.uv))
            assert np.array_equal(ft.kp.valid.numpy(), v)
            assert np.array_equal(ft.kp.score.numpy(), np.asarray(fj.kp.score))
            assert np.array_equal(ft.kp.desc.numpy().view(np.uint32)[v], np.asarray(fj.kp.desc)[v])
            assert np.array_equal(ft.valid.numpy(), np.asarray(fj.valid))
            assert np.array_equal(ft.points.numpy(), np.asarray(fj.points))


def _assert_track_equal(rt, st, rj, sj, tol=1e-5):
    assert int(rt.num_inliers) == int(rj.num_inliers) and bool(st.success) == bool(sj.success)
    assert np.abs(rt.T_ts.numpy() - np.asarray(rj.T_ts)).max() < tol
    v = np.asarray(rj.corr_valid)
    assert np.array_equal(rt.corr_valid.numpy(), v)
    assert np.array_equal(rt.corr_idx.numpy()[v], np.asarray(rj.corr_idx)[v])
    assert abs(float(st.rmse) - float(sj.rmse)) < 1e-5 * max(1.0, float(sj.rmse))
    assert abs(float(st.disparity) - float(sj.disparity)) < 1e-3


def test_tracking_with_summary_matches_jax(orbit7):
    _, _, fj, ft = orbit7
    src, tgt = (jax.tree.map(lambda a: a[i], fj) for i in (0, 2))
    src_t, tgt_t = (tsparse.map_frame(lambda a: a[i], ft) for i in (0, 2))
    key = jax.random.PRNGKey(11)
    draws, _ = _jax_draws(key, src, tgt, hyp=jsparse.RANSAC_HYPOTHESES)
    rj, sj = jsparse.sparse_tracking_with_summary(src, tgt, JCAM160, key)
    rt, st = tsparse.sparse_tracking_with_summary(src_t, tgt_t, CAM, draws=draws)
    assert bool(sj.success)
    _assert_track_equal(rt, st, rj, sj)
    # the port's own draws (a generator seeded 0) track the pair too
    _, own = tsparse.sparse_tracking_with_summary(src_t, tgt_t, CAM)
    assert bool(own.success) and np.abs(own.T_ts.numpy() - np.asarray(sj.T_ts)).max() < 0.02


def test_chunk_scan_with_jax_draws_matches_jax(orbit7):
    """`sparse_chunk_scan` over frames 1-6 from keyframe 0, each frame's
    track fed the draws the JAX scan makes from its key splits against the
    keyframe the JAX scan holds at that step."""
    _, _, fj, ft = orbit7
    kf_pose = np.eye(4, dtype=np.float32)
    key = jax.random.PRNGKey(3)
    frames_j = jax.tree.map(lambda a: a[1:], fj)
    (_, kfp_j), oj = jsparse.sparse_chunk_scan(jax.tree.map(lambda a: a[0], fj), jnp.asarray(kf_pose), frames_j,
                                               JCAM160, key, SCAN_DISPARITY)
    is_kf, pp = np.asarray(oj.is_kf), np.asarray(oj.promote_prev)
    draws, kf, k = [], 0, key  # kf: the chunk frame index (into fj) the scan tracks against
    for i in range(SCAN_FRAMES - 1):
        k, sub = jax.random.split(k)
        draws.append(_jax_draws(sub, jax.tree.map(lambda a: a[kf], fj), jax.tree.map(lambda a: a[i + 1], fj),
                                hyp=jsparse.RANSAC_HYPOTHESES)[0])
        if pp[i]:
            kf = i
        if is_kf[i]:
            kf = i + 1
    (_, kfp_t), ot = tsparse.sparse_chunk_scan(tsparse.map_frame(lambda a: a[0], ft), torch.from_numpy(kf_pose),
                                               tsparse.map_frame(lambda a: a[1:], ft), CAM, None, SCAN_DISPARITY,
                                               draws=draws)
    assert is_kf.sum() >= 1  # a promotion inside the chunk
    assert np.array_equal(ot.is_kf.numpy(), is_kf)
    assert np.array_equal(ot.success.numpy(), np.asarray(oj.success))
    assert np.array_equal(ot.promote_prev.numpy(), pp)
    assert np.abs(ot.T_world.numpy() - np.asarray(oj.T_world)).max() < 1e-4
    assert np.abs(kfp_t.numpy() - np.asarray(kfp_j)).max() < 1e-4
    v = np.asarray(oj.corr_valid)
    assert np.array_equal(ot.corr_valid.numpy(), v)
    assert np.array_equal(ot.corr_idx.numpy()[v], np.asarray(oj.corr_idx)[v])


def test_chunk_scan_promotes_prev_after_a_lost_track(orbit7):
    """A frame that cannot track (no valid point) keeps the last pose and
    promotes the previous frame; the next frame tracks against it."""
    _, _, _, ft = orbit7
    frames = tsparse.map_frame(lambda a: a[1:5].clone(), ft)
    frames.valid[2] = False  # frame 3 of the chunk sees nothing
    gen = torch.Generator().manual_seed(0)
    (kf, _), out = tsparse.sparse_chunk_scan(tsparse.map_frame(lambda a: a[0], ft), torch.eye(4), frames, CAM,
                                             gen, keyframe_disparity=1e9)
    assert out.success.tolist() == [True, True, False, True]
    assert out.promote_prev.tolist() == [False, False, True, False]
    assert not out.is_kf.any()
    assert torch.equal(out.T_world[2], out.T_world[1])
    assert torch.equal(kf.kp.desc, frames.kp.desc[1])  # chunk frame 1, promoted at step 2


def test_track_pairs_batch_with_jax_draws(orbit7):
    _, _, fj, ft = orbit7
    pairs = [(0, 2), (1, 4), (3, 6), (0, 2)]
    srcs_j = jax.tree.map(lambda a: a[jnp.asarray([s for s, _ in pairs])], fj)
    tgts_j = jax.tree.map(lambda a: a[jnp.asarray([t for _, t in pairs])], fj)
    keys = jax.random.split(jax.random.PRNGKey(9), len(pairs))
    rj, sj = jsparse.track_pairs_batch(keys, srcs_j, tgts_j, JCAM160)
    draws = [_jax_draws(keys[p], jax.tree.map(lambda a: a[s], fj), jax.tree.map(lambda a: a[t], fj),
                        hyp=jsparse.RANSAC_HYPOTHESES)[0] for p, (s, t) in enumerate(pairs)]
    srcs_t = tsparse.map_frame(lambda a: a[torch.tensor([s for s, _ in pairs])], ft)
    tgts_t = tsparse.map_frame(lambda a: a[torch.tensor([t for _, t in pairs])], ft)
    rt, st = tsparse.track_pairs_batch(srcs_t, tgts_t, CAM, draws=draws)
    assert rt.T_ts.shape == (len(pairs), 4, 4) and st.disparity.shape == (len(pairs),)
    for p, (s, t) in enumerate(pairs):
        one = tuple(type(x)(*(y[p] for y in x)) for x in (rt, st))
        _assert_track_equal(*one, *(type(x)(*(np.asarray(y)[p] for y in x)) for x in (rj, sj)))
        # and each pair is its own `_track_summary_inner` call, bit for bit
        r1, s1 = tsparse._track_summary_inner(None, tsparse.map_frame(lambda a: a[s], ft),
                                              tsparse.map_frame(lambda a: a[t], ft), CAM, draws=draws[p])
        assert all(torch.equal(a, b) for a, b in zip((*one[0], *one[1]), (*r1, *s1)))


def test_host_loop_defaults_match_jax():
    import inspect

    from onepiece_tpu_torch.systems.fbaslam import FBASlam

    p = inspect.signature(JFBASlam).parameters
    q = inspect.signature(FBASlam).parameters
    for name in ("max_keypoints", "fast_threshold", "keyframe_disparity"):
        assert q[name].default == p[name].default
