"""The port's trajectory metrics (a numpy copy) against the JAX package's,
on noisy copies of the 16-frame orbit made from a seed. Tolerance 1e-12
(the same float64 arithmetic)."""

import numpy as np
import pytest
import torch

from onepiece_tpu.io import trajectory as jtraj
from onepiece_tpu_torch.geometry import se3 as tse3
from onepiece_tpu_torch.io import trajectory as ttraj
from onepiece_tpu_torch.utils import synthetic as tsyn


@pytest.fixture(scope="module")
def poses():
    gt = tsyn.orbit_trajectory(16).astype(np.float64)
    rng = np.random.default_rng(3)
    noise = tse3.se3_exp(torch.from_numpy(rng.normal(scale=0.01, size=(16, 6)))).numpy()
    return gt @ noise, gt


@pytest.mark.parametrize("with_scale", [False, True])
def test_align_umeyama_matches_jax(poses, with_scale):
    est, gt = (p[:, :3, 3] for p in poses)
    np.testing.assert_allclose(
        ttraj.align_umeyama(est, gt, with_scale), jtraj.align_umeyama(est, gt, with_scale), atol=1e-12)


@pytest.mark.parametrize("align", [False, True])
def test_ate_rmse_matches_jax(poses, align):
    a = ttraj.ate_rmse(*poses, align=align)
    assert a > 0 and abs(a - jtraj.ate_rmse(*poses, align=align)) <= 1e-12


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_rmse_matches_jax(poses, delta):
    t, r = ttraj.rpe_rmse(*poses, delta=delta)
    tj, rj = jtraj.rpe_rmse(*poses, delta=delta)
    assert t > 0 and r > 0
    assert abs(t - tj) <= 1e-12 and abs(r - rj) <= 1e-12
