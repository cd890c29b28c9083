"""Parity of the port's dense odometry (normal equations + multi-scale
tracker) with the JAX package.

Inputs: the `__graft_entry__._example_pair` frame pair (160x120, rendered by
the JAX package's renderer with a known small motion), fed to both packages
as numpy arrays.

Tolerances:
  - normal equations, port plain version vs JAX: relative 1e-4 of the
    largest entry (float32 sums over ~19k pixels in another order);
  - port tracker vs JAX `dense_tracking_exact` (the same gather
    formulation): 1e-4 m and 1e-4 rad;
  - port tracker vs JAX `dense_tracking` (the TPU prewarp + stencil form,
    bf16 quad rows): 2.5 mm and 2e-3 rad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry import se3 as jse3
from onepiece_tpu.geometry.camera import PinholeCamera as JCam
from onepiece_tpu.odometry import dense as jdense
from onepiece_tpu.ops import dense_odometry as jdops
from onepiece_tpu.utils import synthetic as jsyn
from onepiece_tpu_torch.geometry.camera import PinholeCamera as TCam
from onepiece_tpu_torch.odometry import dense as tdense
from onepiece_tpu_torch.ops import dense_odometry as tdops

H, W = 120, 160
XI_PAIR = [0.01, -0.01, 0.015, 0.01, -0.015, 0.008]  # __graft_entry__._example_pair


def _cams():
    kw = dict(fx=W / 2.0, fy=W / 2.0, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0, width=W, height=H,
              depth_scale=1000.0)
    return JCam(**kw), TCam(**kw)


@pytest.fixture(scope="module")
def pair():
    jc, tc = _cams()
    scene = jsyn.default_scene()
    T1 = jse3.se3_exp(jnp.asarray(XI_PAIR, jnp.float32))
    frames = []
    for T in (jnp.eye(4), T1):
        d, g = jsyn.render(scene, T, jc.fx, jc.fy, jc.cx, jc.cy, H, W, num_steps=48)
        frames.append((np.array(g), np.array(d)))
    pj = [jdense.preprocess_frame(jnp.asarray(g), jnp.asarray(d), jc) for g, d in frames]
    pt = [tdense.preprocess_frame(torch.from_numpy(g), torch.from_numpy(d), tc) for g, d in frames]
    return jc, tc, pj, pt


def _pose_err(A, B):
    """(translation m, largest rotation-matrix entry) difference."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    return np.abs(A[:3, 3] - B[:3, 3]).max(), np.abs(A[:3, :3] - B[:3, :3]).max()


def test_term_data_matches_jax(pair):
    _, _, pj, pt = pair
    tj = jdops.build_term_data(pj[1].grays[0], pj[1].depths[0], 0.125)
    tt = tdops.build_term_data(pt[1].grays[0], pt[1].depths[0], 0.125)
    for name in tj._fields:
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(tj, name)), atol=1e-5)
    # masked depth Sobel: zero wherever the window touches invalid depth
    assert (tt.zdx[tt.depth == 0] == 0).all() and float(tt.zdx.abs().max()) > 0


@pytest.mark.parametrize(
    "term,huber", [("hybrid", 0.0), ("photo", 0.0), ("depth", 0.0), ("hybrid", 0.05)]
)
def test_normal_equations_plain_matches_jax(pair, term, huber):
    jc, tc, pj, pt = pair
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.004, -0.003, 0.006, 0.004, -0.006, 0.003], jnp.float32)))
    lvl = 0
    tj = jdops.build_term_data(pj[1].grays[lvl], pj[1].depths[lvl], 0.125)
    tt = tdops.build_term_data(pt[1].grays[lvl], pt[1].depths[lvl], 0.125)
    pts = pt[0].xyzs[lvl].reshape(-1, 3)
    gs = pt[0].grays[lvl].reshape(-1)
    ne_j = jdops.normal_equations(
        jnp.asarray(T), jnp.asarray(pts.numpy()), jnp.asarray(gs.numpy()),
        jnp.asarray(pts[:, 2].numpy() > 0), tj, jnp.float32(jc.fx), jnp.float32(jc.fy),
        jnp.float32(jc.cx), jnp.float32(jc.cy), jnp.float32(0.5), jnp.float32(0.05),
        term=term, huber_delta=huber,
    )
    args = (torch.from_numpy(T), pts, gs, pts[:, 2] > 0, tt, tc.fx, tc.fy, tc.cx, tc.cy, 0.5, 0.05)
    if (term, huber) == ("hybrid", 0.0):  # the form the tracker and the kernel take
        ne_t = tdops.normal_equations(*args)
    else:
        ne_t = tdops.normal_equations_reference(*args, term=term, huber_delta=huber)
    assert float(ne_t.num_inliers) == float(ne_j.num_inliers) > 1000
    for a, b in zip(ne_t[:3], ne_j[:3]):
        a = a.numpy()
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def test_solve_and_update_skips_degenerate_systems():
    T = torch.eye(4)
    zero = tdops.NormalEquations(torch.zeros(6, 6), torch.ones(6), torch.tensor(0.0), torch.tensor(100.0))
    assert torch.equal(tdops.solve_and_update(T, zero._replace(JTJ=torch.full((6, 6), float("nan")))), T)
    assert torch.equal(tdops.solve_and_update(T, zero._replace(num_inliers=torch.tensor(5.0))), T)
    assert not torch.equal(tdops.solve_and_update(T, zero._replace(JTJ=torch.eye(6))), T)


def test_kernelled_ops_refuse_devices_without_a_kernel(pair):
    """Only CPU tensors take the plain version; anything else that is not
    CUDA raises instead of silently running it."""
    _, tc, _, pt = pair
    meta = torch.device("meta")
    pts = pt[0].xyzs[2].reshape(-1, 3).to(meta)
    tt = tdops.build_term_data(pt[1].grays[2], pt[1].depths[2]).texels.to(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tdops.normal_equations(
            torch.eye(4, device=meta), pts, pts[:, 0], pts[:, 2] > 0, tdops.TermData(tt),
            tc.fx, tc.fy, tc.cx, tc.cy, 0.5, 0.05,
        )
    with pytest.raises(ValueError, match="unsupported device"):
        tdops.gauss_newton(
            torch.eye(4, device=meta), pts, pts[:, 0], tdops.TermData(tt),
            tc.fx, tc.fy, tc.cx, tc.cy, 0.5, 0.05, iters=2,
        )


def test_tracking_matches_jax_exact_and_prewarp(pair):
    jc, tc, pj, pt = pair
    res_t = tdense.dense_tracking(pt[0], pt[1], tc)
    res_exact = jdense.dense_tracking_exact(pj[0], pj[1], jc)
    dt, dr = _pose_err(res_t.T_ts.numpy(), res_exact.T_ts)
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)
    assert abs(float(res_t.rmse) - float(res_exact.rmse)) <= 1e-4
    res_fast = jdense.dense_tracking(pj[0], pj[1], jc)
    dt, dr = _pose_err(res_t.T_ts.numpy(), res_fast.T_ts)
    assert dt <= 2.5e-3 and dr <= 2e-3, (dt, dr)
    # and it solved the pair: T_ts maps frame-0 points into frame 1
    gt = np.linalg.inv(np.asarray(jse3.se3_exp(jnp.asarray(XI_PAIR, jnp.float32))))
    dt, dr = _pose_err(res_t.T_ts.numpy(), gt)
    assert dt <= 2e-3 and dr <= 2e-3, (dt, dr)


def test_chain_pose_composes_inverse():
    T_w = torch.from_numpy(np.asarray(jse3.se3_exp(jnp.asarray([0.1, 0, 0.2, 0, 0.3, 0], jnp.float32))))
    T_ts = torch.from_numpy(np.asarray(jse3.se3_exp(jnp.asarray([0, 0.05, 0, 0.02, 0, 0], jnp.float32))))
    np.testing.assert_allclose(
        tdense.chain_pose(T_w, T_ts).numpy(), np.asarray(jdense.chain_pose(jnp.asarray(T_w.numpy()), jnp.asarray(T_ts.numpy()))),
        atol=1e-6,
    )
