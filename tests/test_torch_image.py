"""Parity of the PyTorch port's image ops and frame pyramids with the JAX
package, on seeded numpy inputs. Tolerance 1e-5 absolute on values of
order 1 (float32 stencil sums in the same tap order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.odometry import dense as jdense
from onepiece_tpu.ops import image as jimg
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA as TCAM
from onepiece_tpu_torch.odometry import dense as tdense
from onepiece_tpu_torch.ops import image as timg

TOL = 1e-5
H, W = 60, 80


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a.astype(np.float64) - b).max() <= tol


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    gray = rng.uniform(0, 1, (H, W)).astype(np.float32)
    depth = rng.uniform(0.3, 4.5, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.1] = 0.0
    depth[10:20, 30:50] = 0.0
    depth[0, 0] = np.nan
    return gray, depth


@pytest.mark.parametrize("op", ["gaussian_blur", "pyr_down", "box_sum3"])
def test_single_output_stencils_match_jax(images, op):
    gray, _ = images
    _close(getattr(timg, op)(torch.from_numpy(gray)).numpy(), getattr(jimg, op)(jnp.asarray(gray)))


def test_sobel_and_clip_depth_match_jax(images):
    gray, depth = images
    for a, b in zip(timg.sobel(torch.from_numpy(gray)), jimg.sobel(jnp.asarray(gray))):
        _close(a.numpy(), b)
    _close(
        timg.clip_depth(torch.from_numpy(depth), 0.5, 4.0).numpy(),
        jimg.clip_depth(jnp.asarray(depth), 0.5, 4.0),
        tol=0.0,
    )


def test_bilateral_filter_zero_pads_like_jax(images):
    _, depth = images
    depth = np.nan_to_num(depth)
    out = timg.bilateral_filter(torch.from_numpy(depth)).numpy()
    _close(out, jimg.bilateral_filter(jnp.asarray(depth)))
    assert out[0, 0] == 0.0 and (out > 0).sum() == (depth > 0).sum()


@pytest.mark.parametrize("valid_zero", [False, True])
def test_bilinear_sample_matches_jax(images, valid_zero):
    _, depth = images
    depth = np.nan_to_num(depth)
    uv = np.random.default_rng(1).uniform(-2.0, [W + 1.0, H + 1.0], (500, 2)).astype(np.float32)
    vt, ot = timg.bilinear_sample(torch.from_numpy(depth), torch.from_numpy(uv), valid_zero=valid_zero)
    vj, oj = jimg.bilinear_sample(jnp.asarray(depth), jnp.asarray(uv), valid_zero=valid_zero)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert 0 < ot.sum() < len(uv)
    _close(np.where(ot.numpy(), vt.numpy(), 0), np.where(np.asarray(oj), vj, 0))


def test_preprocess_frame_pyramids_match_jax(images):
    gray, depth = images
    cam_t = TCAM.pyramid(4)[3]
    cam_j = JCAM.pyramid(4)[3]
    assert (cam_t.width, cam_t.height) == (W, H)
    pt = tdense.preprocess_frame(torch.from_numpy(gray), torch.from_numpy(depth), cam_t)
    pj = jdense.preprocess_frame(jnp.asarray(gray), jnp.asarray(depth), cam_j)
    for field_t, field_j in zip(pt, pj):
        assert len(field_t) == len(field_j) == 3
        for a, b in zip(field_t, field_j):
            _close(a.numpy(), b)
    # validity erosion: every pixel whose 5x5 blur window touches the hole
    # [10:20, 30:50] is invalid
    assert (pt.depths[0][8:22, 28:52] == 0).all()
