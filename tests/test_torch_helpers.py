"""Parity of the port's last public helpers with the JAX package's, on
seeded numpy inputs:

- `ops/tsdf.debug_point_cloud`: points, colours and mask equal, on
  `tests/test_parity_extras.py`'s two-block case and on a seeded pool;
- `ops/image.build_pyramid`, `scharr`: within 1e-5 (float32 stencil sums in
  the same tap order, `tests/test_torch_image.py`'s tolerance);
  `rgb_to_gray` and `depth_to_meters`: equal;
- `ops/dense_odometry.normalize_intensity_scale`: within 1e-6 relative
  (float32 sums in another order), and 1 where the target's mean is 0;
- `PinholeCamera.in_bounds` and `intrinsic_matrix`: equal;
- `utils/synthetic.render_sequence`: poses within 1e-6, frames by
  `tests/test_torch_synthetic.py`'s rule (depth within 1e-4 m and gray
  within 1e-3 where both hit, hit masks apart on <= 0.5 % of pixels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.ops import dense_odometry as jdo
from onepiece_tpu.ops import image as jimg
from onepiece_tpu.ops import tsdf as jtsdf
from onepiece_tpu.utils import synthetic as jsyn
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA as TCAM
from onepiece_tpu_torch.ops import dense_odometry as tdo
from onepiece_tpu_torch.ops import image as timg
from onepiece_tpu_torch.ops import tsdf as ttsdf
from onepiece_tpu_torch.utils import synthetic as tsyn

H, W = 60, 80


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _debug_cases():
    b = 2
    sdf = np.full((b, 8, 8, 8), jtsdf.EMPTY_SDF, np.float32)
    w = np.zeros((b, 8, 8, 8), np.float32)
    sdf[0, 1, 2, 3], w[0, 1, 2, 3] = 0.02, 5.0
    sdf[1, 0, 0, 0], w[1, 0, 0, 0] = -0.05, 1.0
    sdf[1, 4, 4, 4], w[1, 4, 4, 4] = 0.2, 1.0  # beyond truncation: excluded
    yield sdf, w, np.array([[0, 0, 0], [1, 0, 0]], np.int32), 0.05, 0.1
    rng = np.random.default_rng(0)
    sdf = rng.uniform(-0.15, 0.15, (6, 8, 8, 8)).astype(np.float32)
    w = np.where(rng.uniform(size=sdf.shape) < 0.3, 0.0, rng.uniform(1, 50, sdf.shape)).astype(np.float32)
    yield sdf, w, rng.integers(-20, 20, (6, 3)).astype(np.int32), 0.0125, 0.1


@pytest.mark.parametrize("case", [0, 1])
def test_debug_point_cloud_matches_jax(case):
    sdf, w, bc, vox, trunc = list(_debug_cases())[case]
    pts, cols, valid = ttsdf.debug_point_cloud(torch.from_numpy(sdf), torch.from_numpy(w), torch.from_numpy(bc),
                                               vox, trunc)
    jp, jc, jv = jtsdf.debug_point_cloud(jnp.asarray(sdf), jnp.asarray(w), jnp.asarray(bc), vox, trunc)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jc))
    if case == 0:
        assert int(valid.sum()) == 2


@pytest.fixture(scope="module")
def gray():
    return np.random.default_rng(1).uniform(0, 1, (H, W)).astype(np.float32)


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a.astype(np.float64) - b).max() <= tol


def test_build_pyramid_matches_jax(gray):
    t, j = timg.build_pyramid(torch.from_numpy(gray), 3), jimg.build_pyramid(jnp.asarray(gray), 3)
    assert [x.shape for x in t] == [(60, 80), (30, 40), (15, 20)]
    for a, b in zip(t, j):
        _close(a.numpy(), b)


def test_scharr_matches_jax(gray):
    for a, b in zip(timg.scharr(torch.from_numpy(gray)), jimg.scharr(jnp.asarray(gray))):
        _close(a.numpy(), b)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_to_gray_matches_jax(dtype):
    rgb = np.random.default_rng(2).uniform(0, 255, (H, W, 3)).astype(dtype)
    out = timg.rgb_to_gray(torch.from_numpy(rgb))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jimg.rgb_to_gray(jnp.asarray(rgb))))


@pytest.mark.parametrize("scale", [1000.0, 5000.0])
def test_depth_to_meters_matches_jax(scale):
    raw = np.random.default_rng(3).integers(0, 65536, (H, W)).astype(np.uint16)
    raw[:5] = 0
    out = timg.depth_to_meters(torch.from_numpy(raw.astype(np.int32)), scale)
    ref = np.asarray(jimg.depth_to_meters(jnp.asarray(raw), scale))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[:5] == 0).all()


@pytest.mark.parametrize("case", ["overlap", "dark target"])
def test_normalize_intensity_scale_matches_jax(case):
    rng = np.random.default_rng(4)
    src = rng.uniform(0, 1, (H * W,)).astype(np.float32)
    tgt = rng.uniform(0, 1, (H * W,)).astype(np.float32) * (0.0 if case == "dark target" else 1.3)
    sv, tv = rng.uniform(size=H * W) < 0.8, rng.uniform(size=H * W) < 0.7
    out = float(tdo.normalize_intensity_scale(*map(torch.from_numpy, (src, sv, tgt, tv))))
    ref = float(jdo.normalize_intensity_scale(*map(jnp.asarray, (src, sv, tgt, tv))))
    assert abs(out - ref) <= 1e-6 * abs(ref)
    if case == "dark target":
        assert out == 1.0


@pytest.mark.parametrize("margin", [0.0, 2.5])
def test_in_bounds_matches_jax(margin):
    uv = np.random.default_rng(5).uniform(-5, 650, (500, 2)).astype(np.float32)
    uv[:4] = [[0, 0], [639, 479], [639.01, 0], [2.5, 476.5]]  # edges and margins
    out = TCAM.in_bounds(torch.from_numpy(uv), margin)
    np.testing.assert_array_equal(out.numpy(), np.asarray(JCAM.in_bounds(jnp.asarray(uv), margin)))


def test_intrinsic_matrix_matches_jax():
    k = TCAM.intrinsic_matrix(device="cpu")
    assert k.dtype == torch.float32
    np.testing.assert_array_equal(k.numpy(), np.asarray(JCAM.intrinsic_matrix()))


def test_render_sequence_matches_jax():
    cam_t, cam_j = TCAM.pyramid(4)[3], JCAM.pyramid(4)[3]
    dt, gt, pt = tsyn.render_sequence(3, cam_t, num_steps=48, device="cpu")
    dj, gj, pj = jsyn.render_sequence(3, cam_j, num_steps=48)
    assert dt.shape == np.asarray(dj).shape == (3, 60, 80) and dt.dtype == np.float32
    assert np.abs(pt - np.asarray(pj)).max() <= 1e-6
    both = (dt > 0) & (np.asarray(dj) > 0)
    assert both.mean() > 0.9 and ((dt > 0) != (np.asarray(dj) > 0)).mean() <= 0.005
    assert np.abs(dt - np.asarray(dj))[both].max() <= 1e-4
    assert np.abs(gt - np.asarray(gj))[both].max() <= 1e-3
