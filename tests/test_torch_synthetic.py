"""Parity of the port's synthetic renderer and trajectories with the JAX
package's. Tolerances: depth within 1e-4 m on pixels both renderers hit;
hit masks differ on <= 0.5 % of pixels (sphere tracing in float32 can end a
grazing ray on either side of the hit threshold, and the nearest-primitive
argmin can flip on a tie); gray within 1e-3 where both hit; poses 1e-6. The sensor-noise model is
numpy in both packages and must agree bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.utils import synthetic as jsyn
from onepiece_tpu_torch.utils import synthetic as tsyn

H, W = 60, 80
INTR = (64.6625, 64.5625, 39.3875, 31.475)  # TUM intrinsics, 3 pyramid levels down


@pytest.mark.parametrize("fn", ["orbit_trajectory", "loop_trajectory"])
def test_trajectories_match_jax(fn):
    a = getattr(tsyn, fn)(16)
    b = getattr(jsyn, fn)(16)
    assert a.shape == b.shape == (16, 4, 4) and a.dtype == np.float32
    assert np.abs(a - b).max() <= 1e-6


@pytest.mark.parametrize("frame", [0, 9])
def test_render_matches_jax(frame):
    pose = tsyn.orbit_trajectory(16)[frame]
    dt, gt = tsyn.render(tsyn.default_scene(), torch.from_numpy(pose), *INTR, H, W, num_steps=64)
    dj, gj = jsyn.render(jsyn.default_scene(), jnp.asarray(pose), *INTR, H, W, num_steps=64)
    dt, gt, dj, gj = dt.numpy(), gt.numpy(), np.asarray(dj), np.asarray(gj)
    both = (dt > 0) & (dj > 0)
    assert both.mean() > 0.9
    assert ((dt > 0) != (dj > 0)).mean() <= 0.005
    assert np.abs(dt - dj)[both].max() <= 1e-4
    assert np.abs(gt - gj)[both].max() <= 1e-3


def test_scene_sdf_matches_jax():
    p = np.random.default_rng(0).uniform(-2, 4, (500, 3)).astype(np.float32)
    dt, at = tsyn.scene_sdf(tsyn.default_scene(), torch.from_numpy(p))
    dj, aj = jsyn.scene_sdf(jsyn.default_scene(), jnp.asarray(p))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


@pytest.mark.parametrize("textureless", [None, (1, 3)])
def test_corrupt_sequence_matches_jax_bit_for_bit(textureless):
    rng = np.random.default_rng(5)
    depths = rng.uniform(0.3, 4.0, (4, H, W)).astype(np.float32)
    depths[:, :5] = 0.0  # no return: stays 0
    grays = rng.uniform(0.0, 1.0, (4, H, W)).astype(np.float32)
    for quantize in (True, False):
        a = tsyn.corrupt_sequence(grays, depths, seed=7, textureless=textureless, quantize=quantize)
        b = jsyn.corrupt_sequence(grays, depths, seed=7, textureless=textureless, quantize=quantize)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)
    g, d = tsyn.corrupt_rgbd(np.random.default_rng(3), grays[0], depths[0], holes=3, contrast=0.5)
    gj, dj = jsyn.corrupt_rgbd(np.random.default_rng(3), grays[0], depths[0], holes=3, contrast=0.5)
    assert np.array_equal(g, gj) and np.array_equal(d, dj) and (d == 0).any()
    assert all(np.array_equal(x, y) for x, y in zip(tsyn.quantize_rgbd(g, d), jsyn.quantize_rgbd(g, d)))
