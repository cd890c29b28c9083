"""The port's FAST/BRIEF front end and its Hamming matching against the JAX
package, on the CPU (plain versions).

Inputs: frames of the synthetic scene rendered by the port at 160x120 and
a seeded numpy texture, passed to both packages as numpy arrays.
Tolerances: FAST response, NMS, blur, keypoints (pixels, scores, order)
and backprojected points bit-equal; angle bins >= 99.5 % equal (atan2 may
differ in its last bit, which can move an angle across a bin edge);
descriptors bit-equal wherever the bins agree; Hamming tables, matches,
ratio tests, windowed matches and the mutual filter equal, on descriptors
with deliberate ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.odometry import features as jfeat
from onepiece_tpu.odometry import sparse as jsparse
from onepiece_tpu.ops import hamming as jham
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.odometry import features as tfeat
from onepiece_tpu_torch.odometry import sparse as tsparse
from onepiece_tpu_torch.ops import hamming as tham
from onepiece_tpu_torch.utils import synthetic

CAM = TUM_CAMERA.pyramid(3)[2]  # 160x120
JCAM160 = JCAM.next_pyramid_level().next_pyramid_level()
THRESHOLD = 0.01  # FusedFBASlam's FAST threshold
BIN = 2 * np.pi / tfeat.NUM_ANGLE_BINS


@pytest.fixture(scope="module")
def images():
    """Two rendered frames of the orbit and one seeded texture, (3, 120, 160),
    with the two frames' depths."""
    poses = synthetic.orbit_trajectory(12)
    scene = synthetic.default_scene()
    out = [synthetic.render(scene, torch.from_numpy(poses[i]), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                            CAM.height, CAM.width, num_steps=64) for i in (0, 3)]
    rng = np.random.default_rng(0)
    tex = np.kron(rng.random((15, 20)), np.ones((8, 8)))  # 8x8-pixel cells: many corners and ties
    grays = np.stack([o[1].numpy() for o in out] + [tex]).astype(np.float32)
    depths = np.stack([o[0].numpy() for o in out])
    return grays, depths


def _u32(desc: torch.Tensor) -> np.ndarray:
    return desc.numpy().view(np.uint32)


def test_fast_response_nms_and_blur_bit_equal(images):
    grays, _ = images
    rj = np.array(jfeat._fast_response(jnp.asarray(grays), THRESHOLD))
    rt = tfeat._fast_response(torch.from_numpy(grays), THRESHOLD).numpy()
    assert np.array_equal(rt, rj) and (rj > 0).sum() > 1000
    for radius in (1, 2):
        assert np.array_equal(tfeat._nms(torch.from_numpy(rj), radius).numpy(),
                              np.asarray(jfeat._nms(jnp.asarray(rj), radius)))
    assert np.array_equal(tfeat._blur5_batch(torch.from_numpy(grays)).numpy(),
                          np.asarray(jfeat._blur5_batch(jnp.asarray(grays))))


def test_keypoints_orientation_and_descriptors_match_jax(images):
    grays, _ = images
    kj = jfeat.detect_and_describe_batch(jnp.asarray(grays), max_keypoints=500, threshold=THRESHOLD)
    kt = tfeat.detect_and_describe_batch(torch.from_numpy(grays), max_keypoints=500, threshold=THRESHOLD)
    # index sets and their order (ties among scores: lowest pixel index first)
    assert np.array_equal(kt.uv.numpy(), np.asarray(kj.uv))
    assert np.array_equal(kt.score.numpy(), np.asarray(kj.score))
    valid = np.asarray(kj.valid)
    assert np.array_equal(kt.valid.numpy(), valid) and valid.sum(1).min() > 100
    bj = np.round(np.asarray(kj.angle) / BIN).astype(int) % tfeat.NUM_ANGLE_BINS
    bt = np.round(kt.angle.numpy() / BIN).astype(int) % tfeat.NUM_ANGLE_BINS
    same_bin = (bj == bt) & valid
    assert same_bin.sum() >= 0.995 * valid.sum()
    eq = (_u32(kt.desc) == np.asarray(kj.desc)).all(-1)
    assert eq[same_bin].all()


def test_single_frame_detect_matches_jax(images):
    grays, _ = images
    kj = jfeat.detect_and_describe(jnp.asarray(grays[2]), max_keypoints=300, threshold=THRESHOLD)
    kt = tfeat.detect_and_describe(torch.from_numpy(grays[2]), max_keypoints=300, threshold=THRESHOLD)
    v = np.asarray(kj.valid)
    assert np.array_equal(kt.uv.numpy(), np.asarray(kj.uv)) and np.array_equal(kt.valid.numpy(), v)
    assert (_u32(kt.desc) == np.asarray(kj.desc)).all(-1)[v].mean() >= 0.995


def test_extract_sparse_frames_batch_points_bit_equal(images):
    grays, depths = images
    fj = jsparse.extract_sparse_frames_batch(jnp.asarray(grays[:2]), jnp.asarray(depths), JCAM160,
                                             max_keypoints=500, threshold=THRESHOLD)
    ft = tsparse.extract_sparse_frames_batch(torch.from_numpy(grays[:2]), torch.from_numpy(depths), CAM,
                                             max_keypoints=500, threshold=THRESHOLD)
    assert np.array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    assert np.array_equal(ft.points.numpy(), np.asarray(fj.points))


def _tied_descriptors(seed: int, n: int, m: int):
    """Random (N, 8) and (M, 8) descriptors where some targets repeat
    others exactly and some queries sit at equal distance from two targets."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint64).astype(np.uint32)
    b[1::7] = b[0:-1:7]  # exact duplicates: equal distances at two indices
    a = b[rng.integers(0, m, n)].copy()
    flips = rng.integers(0, 256, (n, 6))  # a few bits off their source target
    for i in range(n):
        for bit in flips[i, : rng.integers(0, 6)]:
            a[i, bit // 32] ^= np.uint32(1) << np.uint32(bit % 32)
    a[: n // 4] = rng.integers(0, 2**32, (n // 4, 8), dtype=np.uint64).astype(np.uint32)  # unmatched queries
    va = rng.random(n) > 0.1
    vb = rng.random(m) > 0.1
    return a, va, b, vb


def _t(x, dtype=None):
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x) if dtype is None else torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("seed", [0, 1])
def test_hamming_table_and_matches_match_jax(seed):
    a, va, b, vb = _tied_descriptors(seed, 300, 250)
    assert np.array_equal(tham.hamming_table(_t(a), _t(b)).numpy(), np.asarray(jham.hamming_table(a, b)))
    ij, okj = jham.match_descriptors(a, va, b, vb)
    it, okt = tham.match_descriptors(_t(a), _t(va), _t(b), _t(vb))
    assert np.array_equal(it.numpy(), np.asarray(ij)) and np.array_equal(okt.numpy(), np.asarray(okj))
    assert 20 < np.asarray(okj).sum() < 300
    rng = np.random.default_rng(seed + 10)
    uv_pred = rng.uniform(0, 160, (300, 2)).astype(np.float32)
    uv_b = rng.uniform(0, 160, (250, 2)).astype(np.float32)
    uv_b[1::7] = uv_b[0:-1:7]  # duplicates in the same window too
    for window in (20.0, 200.0):
        ij, okj = jham.match_descriptors_windowed(a, va, b, vb, uv_pred, uv_b, window)
        it, okt = tham.match_descriptors_windowed(_t(a), _t(va), _t(b), _t(vb), _t(uv_pred), _t(uv_b), window)
        assert np.array_equal(it.numpy(), np.asarray(ij)) and np.array_equal(okt.numpy(), np.asarray(okj))
    ij, okj = jham.match_descriptors(a, va, b, vb)
    back, _ = jham.match_descriptors(b, vb, a, va)
    it, okt = tham.match_descriptors(_t(a), _t(va), _t(b), _t(vb))
    bt, _ = tham.match_descriptors(_t(b), _t(vb), _t(a), _t(va))
    assert np.array_equal(tham.mutual_filter(it, okt, bt).numpy(), np.asarray(jham.mutual_filter(ij, okj, back)))


def test_hamming_match_ties_go_to_the_lowest_index():
    d = np.zeros((1, 8), np.uint32)
    b = np.zeros((4, 8), np.uint32)
    b[0, 0] = 0b111  # distance 3
    b[1, 0] = 0b1111  # 4
    b[2, 0] = 0b1  # distance 1, twice
    b[3, 0] = 0b10
    best, bd, sd = tham.hamming_match(_t(d), _t(b), torch.ones(4, dtype=torch.bool))
    assert (int(best[0]), int(bd[0]), int(sd[0])) == (2, 1, 1)
    best, bd, sd = tham.hamming_match(_t(d), _t(b), torch.tensor([True, True, False, True]))
    assert (int(best[0]), int(bd[0]), int(sd[0])) == (3, 1, 3)
