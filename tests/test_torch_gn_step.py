"""The plain version of the port's Gauss-Newton step (`solve6_reference`,
`solve_and_update`, `gn_step_reference`) against the JAX package's
`solve_and_update` (`onepiece_tpu/ops/dense_odometry.py:173`), as cases of
one parametrised test. Inputs are made from a seed with numpy, or rendered
by the JAX package, and handed to both packages as numpy arrays.

Cases and tolerances:
  - `spd-*`: random symmetric positive definite 6x6 systems of condition
    number 1e1, 1e2 and 1e4. The solution is held against a float64 numpy
    solve of the same float32 inputs: backward error |A x - b| / (|A| |x|)
    <= 6 float32 epsilons (LU with partial pivoting is backward stable), and
    forward error <= max(1e-5, cond * eps32) relative to the largest entry.
    At cond 1e4 no float32 solve can promise 1e-5 (cond * eps32 = 1.2e-3),
    JAX's own `jnp.linalg.solve` included.
  - `pair*`: the JTJ / JTr of real 80x60 frame pairs (first frames of the
    orbit, all three pyramid levels), computed by the JAX package at a small
    pose (at the identity every point projects onto a pixel corner, where
    floor() rounding moves ~2 % of the inliers): the port's step from them
    within 1e-6 of JAX's T. The whole
    plain step (the port's own normal equations, then the solve) within
    1e-5 of JAX's (normal equations summed in another order, rel ~1e-6).
  - degenerate systems (NaN JTJ, 6 inliers, an exactly zero pivot): both
    packages return T unchanged, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry import se3 as jse3
from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.odometry import dense as jdense
from onepiece_tpu.ops import dense_odometry as jdops
from onepiece_tpu.utils import synthetic as jsyn
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA as TCAM
from onepiece_tpu_torch.odometry import dense as tdense
from onepiece_tpu_torch.ops import dense_odometry as tdops

EPS32 = float(np.finfo(np.float32).eps)
T0 = np.array([[0.99, -0.1, 0.05, 0.2], [0.1, 0.99, 0.0, -0.1], [-0.05, 0.0, 1.0, 0.3],
               [0.0, 0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def pairs():
    """JAX and port pyramids of the first three 80x60 orbit frames."""
    jc, tc = JCAM.pyramid(4)[3], TCAM.pyramid(4)[3]
    scene = jsyn.default_scene()
    frames = [
        jsyn.render(scene, jnp.asarray(p), jc.fx, jc.fy, jc.cx, jc.cy, jc.height, jc.width, num_steps=48)
        for p in jsyn.orbit_trajectory(16)[:3]
    ]
    pj = [jdense.preprocess_frame(g, d, jc) for d, g in frames]
    pt = [tdense.preprocess_frame(torch.from_numpy(np.array(g)), torch.from_numpy(np.array(d)), tc)
          for d, g in frames]
    return jc, tc, pj, pt


def _spd(cond: float, seed: int):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    a = (q * np.logspace(0, np.log10(cond), 6)) @ q.T
    return ((a + a.T) / 2).astype(np.float32), rng.standard_normal(6).astype(np.float32)


def _ne_pair(pairs, i: int, lvl: int):
    """Arguments of one linearisation at a small pose, in both packages."""
    jc, tc, pj, pt = pairs
    cj, ct = jc.pyramid(3)[lvl], tc.pyramid(3)[lvl]
    tgt_j = jdops.build_term_data(pj[i + 1].grays[lvl], pj[i + 1].depths[lvl], 0.125)
    pts_j = pj[i].xyzs[lvl].reshape(-1, 3)
    T = np.array(jse3.se3_exp(jnp.asarray([0.004, -0.003, 0.006, 0.004, -0.006, 0.003], jnp.float32)))
    args_j = (jnp.asarray(T), pts_j, pj[i].grays[lvl].reshape(-1), pts_j[:, 2] > 0, tgt_j,
              *(jnp.float32(v) for v in (cj.fx, cj.fy, cj.cx, cj.cy, 0.5, 0.05)))
    tgt_t = tdops.build_term_data(pt[i + 1].grays[lvl], pt[i + 1].depths[lvl], 0.125)
    pts_t = pt[i].xyzs[lvl].reshape(-1, 3)
    args_t = (torch.from_numpy(T), pts_t, pt[i].grays[lvl].reshape(-1), pts_t[:, 2] > 0, tgt_t,
              ct.fx, ct.fy, ct.cx, ct.cy, 0.5, 0.05)
    return args_j, args_t


def _degenerate(kind: str):
    jtj = np.eye(6, dtype=np.float32) * 2.0
    jtr = np.arange(1, 7, dtype=np.float32) * 0.01
    inliers = 100.0
    if kind == "nan_jtj":
        jtj[:] = np.nan
    elif kind == "few_inliers":
        inliers = 6.0
    elif kind == "zero_pivot":  # + damping 1e-6 makes pivot 4 exactly zero
        jtj[4, 4] = np.float32(-1e-6)
    return jtj, jtr, inliers


CASES = ["spd-cond1e1", "spd-cond1e2", "spd-cond1e4", "pair0-level0", "pair0-level1",
         "pair0-level2", "pair1-level0", "nan_jtj", "few_inliers", "zero_pivot"]


@pytest.mark.parametrize("case", CASES)
def test_gn_step_plain_matches_jax(case, request):
    if case.startswith("spd"):
        cond = float(case.split("cond")[1])
        for seed in range(20):
            a, b = _spd(cond, seed)
            x, nonsingular = tdops.solve6_reference(torch.from_numpy(a), torch.from_numpy(b))
            assert bool(nonsingular)
            x = x.numpy().astype(np.float64)
            a64, b64 = a.astype(np.float64), b.astype(np.float64)
            backward = np.abs(a64 @ x - b64).max() / (np.abs(a64).max() * np.abs(x).max())
            assert backward <= 6 * EPS32, (seed, backward)
            x64 = np.linalg.solve(a64, b64)
            forward = np.abs(x - x64).max() / np.abs(x64).max()
            assert forward <= max(1e-5, cond * EPS32), (seed, forward)
        return

    if case.startswith("pair"):
        pairs = request.getfixturevalue("pairs")
        i, lvl = int(case[4]), int(case[-1])
        args_j, args_t = _ne_pair(pairs, i, lvl)
        ne_j = jdops.normal_equations(*args_j)
        T_j = np.asarray(jdops.solve_and_update(args_j[0], ne_j))
        ne_from_j = tdops.NormalEquations(*(torch.from_numpy(np.array(v)) for v in ne_j))
        assert float(ne_j.num_inliers) > 6
        assert np.abs(tdops.solve_and_update(args_t[0], ne_from_j).numpy() - T_j).max() <= 1e-6
        T_t, ne_t = tdops.gn_step_reference(*args_t)
        assert float(ne_t.num_inliers) == float(ne_j.num_inliers)
        assert np.abs(T_t.numpy() - T_j).max() <= 1e-5
        assert np.abs(T_j - np.asarray(args_j[0])).max() > 1e-3  # a real step was taken
        return

    jtj, jtr, inliers = _degenerate(case)
    T_j = np.asarray(jdops.solve_and_update(jnp.asarray(T0), jdops.NormalEquations(
        jnp.asarray(jtj), jnp.asarray(jtr), jnp.float32(0.0), jnp.float32(inliers))))
    ne_t = tdops.NormalEquations(torch.from_numpy(jtj), torch.from_numpy(jtr), torch.tensor(0.0),
                                 torch.tensor(inliers))
    T_t = tdops.solve_and_update(torch.from_numpy(T0), ne_t).numpy()
    assert np.array_equal(T_t, T0) and np.array_equal(T_j, T0)
    if case == "zero_pivot":
        A = torch.from_numpy(jtj) + 1e-6 * torch.eye(6)
        assert not bool(tdops.solve6_reference(A, -torch.from_numpy(jtr))[1])


def test_gauss_newton_updates_T_in_place_as_steps_do(pairs):
    """`gauss_newton` on CPU tensors: `iters` plain steps, T updated in
    place, the normal equations of the last step returned."""
    _, args_t = _ne_pair(pairs, 0, 0)
    T_steps = args_t[0].clone()
    for _ in range(3):
        T_steps, ne_last = tdops.gn_step_reference(T_steps, *args_t[1:])
    T = args_t[0].clone()
    pts, gray, _, tgt, *rest = args_t[1:]
    ne = tdops.gauss_newton(T, pts, gray, tgt, *rest, iters=3)
    assert torch.equal(T, T_steps)
    for a, b in zip(ne, ne_last):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="iters"):
        tdops.gauss_newton(T, pts, gray, tgt, *rest, iters=0)
