"""Parity of the PyTorch port's SE(3) math and camera with the JAX package.

Inputs are made with numpy from a seed and fed to both packages; JAX runs
on the CPU (tests/conftest.py). Tolerance: relative 1e-6 of the largest
entry (float32 round-off of a few ops)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from onepiece_tpu.geometry import camera as jcam
from onepiece_tpu.geometry import se3 as jse3
from onepiece_tpu_torch.geometry import camera as tcam
from onepiece_tpu_torch.geometry import se3 as tse3

REL = 1e-6


def _close(a, b, rel=REL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1.0), np.abs(a - b).max()


def _twists(scale):
    xi = np.random.default_rng(0).normal(size=(16, 6)) * scale
    xi[0] = 0.0  # exactly zero rotation: the Taylor branch
    xi[1, 3:] = 1e-5  # tiny rotation
    return xi.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scale", [1e-3, 0.5])
def test_se3_exp_inverse_transform_match_jax(dtype, scale):
    xi = _twists(scale)
    T_j = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    T_t = tse3.se3_exp(torch.from_numpy(xi).to(dtype))
    assert T_t.dtype == dtype
    _close(T_t.numpy(), T_j)
    _close(tse3.so3_exp(torch.from_numpy(xi[:, 3:]).to(dtype)).numpy(),
           np.asarray(jse3.so3_exp(jnp.asarray(xi[:, 3:]))))
    _close(tse3.skew(torch.from_numpy(xi[:, :3]).to(dtype)).numpy(),
           np.asarray(jse3.skew(jnp.asarray(xi[:, :3]))))
    _close(tse3.inverse_T(T_t).numpy(), np.asarray(jse3.inverse_T(jnp.asarray(T_j))))
    pts = np.random.default_rng(1).normal(size=(16, 50, 3)).astype(np.float32)
    _close(
        tse3.transform_points(T_t, torch.from_numpy(pts).to(dtype)).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(T_j), jnp.asarray(pts))),
    )


def test_so3_exp_float64_is_exact_rodrigues():
    """The float64 path is true float64 (not float32 in disguise)."""
    phi = np.random.default_rng(2).normal(size=(32, 3)) * 0.7
    R = tse3.so3_exp(torch.from_numpy(phi)).numpy()
    np.testing.assert_allclose(R, Rotation.from_rotvec(phi).as_matrix(), atol=1e-13)
    T = tse3.se3_exp(torch.from_numpy(np.concatenate([phi, phi], -1)))
    np.testing.assert_allclose((tse3.inverse_T(T) @ T).numpy(), np.broadcast_to(np.eye(4), T.shape), atol=1e-13)


def test_camera_pyramid_and_backprojection_match_jax():
    cams_t = tcam.TUM_CAMERA.pyramid(4)
    cams_j = jcam.TUM_CAMERA.pyramid(4)
    for ct, cj in zip(cams_t, cams_j):
        assert (ct.width, ct.height) == (cj.width, cj.height)
        _close([ct.fx, ct.fy, ct.cx, ct.cy], [cj.fx, cj.fy, cj.cx, cj.cy])
    # the pyrDown principal-point convention, (c + 0.5) / 2 - 0.5
    assert cams_t[1].cx == (tcam.TUM_CAMERA.cx + 0.5) * 0.5 - 0.5
    c = cams_t[2]
    depth = np.random.default_rng(3).uniform(0.0, 4.0, (c.height, c.width)).astype(np.float32)
    depth[::7, ::5] = 0.0
    _close(
        c.backproject_grid(torch.from_numpy(depth)).numpy(),
        np.asarray(cams_j[2].backproject_grid(jnp.asarray(depth))),
    )
