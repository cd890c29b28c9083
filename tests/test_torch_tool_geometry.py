"""What only the tools use, in the port, against the JAX package on the CPU:
`ops/ransac.{ransac_plane,homography_filter}`, `geometry/transforms.
{fit_plane,fit_line,plane_point_distance}`, `geometry/se3.{so3_log,se3_log}`,
`geometry/geometry2d`, `integration/frustum`, the ATE sweep's options of
`odometry/dense` (`preprocess_frame(depth_blur=, intensity_norm=)`,
`dense_tracking(pair_norm=, depth_diff_max=)`), and the two tools
`tools/torch_ransac_test.py` and `tools/torch_ate_sweep.py`.

Tolerances: the RANSACs fed the JAX package's draws give masks equal and
planes within 1e-5 (a plane and its negation are one plane: the SVD's sign
is its own in each package); the fits and logarithms within 1e-5; the 2-D
predicates equal (the same numpy); frustum planes within 1e-6 and
containment equal; preprocessing within 1e-6; tracking with pair
normalisation within `tests/test_torch_dense_odometry.py`'s 1e-4 m and
1e-4 rad of `dense_tracking_exact`.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry import geometry2d as jg2d
from onepiece_tpu.geometry import se3 as jse3
from onepiece_tpu.geometry import transforms as jtf
from onepiece_tpu.geometry.camera import PinholeCamera as JCam
from onepiece_tpu.integration import frustum as jfr
from onepiece_tpu.odometry import dense as jdense
from onepiece_tpu.ops import ransac as jransac
from onepiece_tpu_torch.geometry import geometry2d as tg2d
from onepiece_tpu_torch.geometry import se3 as tse3
from onepiece_tpu_torch.geometry import transforms as ttf
from onepiece_tpu_torch.geometry.camera import PinholeCamera as TCam
from onepiece_tpu_torch.integration import frustum as tfr
from onepiece_tpu_torch.odometry import dense as tdense
from onepiece_tpu_torch.ops import ransac as transac
from onepiece_tpu_torch.utils import synthetic

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))
import torch_ate_sweep  # noqa: E402

H, W = 120, 160
_CAM = dict(fx=W / 2.0, fy=W / 2.0, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0, width=W, height=H, depth_scale=1000.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs (the test workers share the
    host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def N(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _same_plane(a, b, tol=1e-5):
    a, b = N(a), N(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max()) <= tol


# ---- RANSAC --------------------------------------------------------------------

def test_ransac_plane_with_jax_draws():
    rng = np.random.default_rng(1)
    n = 300
    pts = np.zeros((n, 3), np.float32)
    pts[:, :2] = rng.uniform(-1, 1, (n, 2))
    nrm = np.array([0.2, -0.3, 0.93]) / np.linalg.norm([0.2, -0.3, 0.93])
    pts[:, 2] = -(pts[:, 0] * nrm[0] + pts[:, 1] * nrm[1] + 0.4) / nrm[2]
    pts += rng.normal(0, 0.005, pts.shape).astype(np.float32)
    pts[:100] = rng.uniform(-2, 2, (100, 3))
    valid = rng.random(n) > 0.05
    key = jax.random.PRNGKey(4)
    samples = np.asarray(jransac._sample_indices(key, jnp.asarray(valid), 128, 3))
    pj, mj = jransac.ransac_plane(key, jnp.asarray(pts), jnp.asarray(valid), threshold=0.02, num_hypotheses=128)
    pt, mt = transac.ransac_plane(None, torch.from_numpy(pts), torch.from_numpy(valid), threshold=0.02,
                                  num_hypotheses=128, samples=torch.from_numpy(samples.astype(np.int64)))
    assert _same_plane(pt, pj)
    assert np.array_equal(N(mt), N(mj)) and N(mt).sum() > 150
    # the port's own draws find the plane too
    own, _ = transac.ransac_plane(torch.Generator().manual_seed(0), torch.from_numpy(pts), torch.from_numpy(valid))
    assert abs(abs(float(N(own)[:3] @ nrm)) - 1.0) < 1e-3


@pytest.mark.parametrize("outliers", [120, 390])  # the second: no hypothesis keeps a quarter -> the input mask
def test_homography_filter_with_jax_draws(outliers):
    rng = np.random.default_rng(2)
    n = 400
    uv = rng.uniform(0, 640, (n, 2))
    Hm = np.array([[1.02, 0.05, 12.0], [-0.04, 0.98, -7.0], [1e-4, -5e-5, 1.0]])
    proj = np.c_[uv, np.ones(n)] @ Hm.T
    uv2 = proj[:, :2] / proj[:, 2:] + rng.normal(0, 1.0, (n, 2))
    uv2[:outliers] = rng.uniform(0, 640, (outliers, 2))
    uv, uv2 = uv.astype(np.float32), uv2.astype(np.float32)
    valid = rng.random(n) > 0.1
    key = jax.random.PRNGKey(6)
    samples = np.asarray(jransac._sample_indices(key, jnp.asarray(valid), 256, 4))
    mj = jransac.homography_filter(key, jnp.asarray(uv), jnp.asarray(uv2), jnp.asarray(valid))
    mt = transac.homography_filter(None, torch.from_numpy(uv), torch.from_numpy(uv2), torch.from_numpy(valid),
                                   samples=torch.from_numpy(samples.astype(np.int64)))
    assert np.array_equal(N(mt), N(mj))
    if outliers == 120:
        assert N(mt)[outliers:][valid[outliers:]].mean() > 0.95 and N(mt)[:outliers].mean() < 0.05


# ---- fits and logarithms ----------------------------------------------------------

def test_fit_plane_fit_line_plane_distance_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(4, 60, 3)).astype(np.float32) * np.float32([1.0, 0.6, 0.05])
    w = rng.random((4, 60)).astype(np.float32)
    for weights in (None, w):
        pj = jtf.fit_plane(jnp.asarray(pts), None if weights is None else jnp.asarray(weights))
        pt = ttf.fit_plane(torch.from_numpy(pts), None if weights is None else torch.from_numpy(weights))
        assert pt.shape == (4, 4) and all(_same_plane(a, b) for a, b in zip(pt, N(pj)))
    line = (rng.normal(size=(50, 1)) * np.float32([[0.3, -0.8, 0.5]]) + rng.normal(size=(50, 3)) * 0.01
            + 2.0).astype(np.float32)
    (mj, dj), (mt, dt) = jtf.fit_line(jnp.asarray(line)), ttf.fit_line(torch.from_numpy(line))
    assert np.abs(N(mt) - N(mj)).max() <= 1e-5 and _same_plane(dt, dj)
    plane = np.float32([0.36, -0.48, 0.8, 0.3])
    np.testing.assert_allclose(N(ttf.plane_point_distance(torch.from_numpy(plane), torch.from_numpy(pts))),
                               N(jtf.plane_point_distance(jnp.asarray(plane), jnp.asarray(pts))), atol=1e-6)


def _rotations():
    """Angles near 0 (both sides of the Taylor switch), generic, and near pi
    (both sides of the axis-from-diagonal switch)."""
    rng = np.random.default_rng(8)
    axes = rng.normal(size=(8, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([0.0, 3e-5, 5e-3, 0.3, 1.7, np.pi - 0.05, np.pi - 2e-4, np.pi])
    return (axes * angles[:, None]).astype(np.float32)


def test_so3_log_se3_log_match_jax():
    phi = _rotations()
    R = N(tse3.so3_exp(torch.from_numpy(phi)))
    lt, lj = N(tse3.so3_log(torch.from_numpy(R))), N(jse3.so3_log(jnp.asarray(R)))
    assert np.abs(lt - lj).max() <= 1e-5
    # away from pi it inverts so3_exp (near pi the float32 axis-from-diagonal
    # form loses digits in both packages alike)
    back = N(tse3.so3_exp(torch.from_numpy(lt[:5])))
    assert np.abs(back - R[:5]).max() <= 1e-5
    rho = np.random.default_rng(9).normal(size=(8, 3)).astype(np.float32)
    xi = np.concatenate([rho, phi], 1)
    T = N(tse3.se3_exp(torch.from_numpy(xi)))
    st, sj = N(tse3.se3_log(torch.from_numpy(T))), N(jse3.se3_log(jnp.asarray(T)))
    assert np.abs(st - sj).max() <= 1e-5
    assert np.abs(st[:5] - xi[:5]).max() <= 1e-4  # away from pi, log(exp(xi)) = xi
    Vt = N(tse3._so3_left_jacobian_inv(torch.from_numpy(phi)))
    Vj = N(jse3._so3_left_jacobian_inv(jnp.asarray(phi)))
    assert np.abs(Vt - Vj).max() <= 1e-5


# ---- 2-D predicates, the frustum ------------------------------------------------

def test_geometry2d_functions_equal():
    rng = np.random.default_rng(10)
    a, b, c = (rng.normal(size=(20, 2)) for _ in range(3))
    assert np.array_equal(tg2d.cross2(a, b), jg2d.cross2(a, b))
    assert np.array_equal(tg2d.orientation(a, b, c), jg2d.orientation(a, b, c))
    segs = [((0, 0), (2, 2), (0, 2), (2, 0)), ((0, 0), (1, 0), (2, 0), (3, 0)), ((0, 0), (2, 0), (1, 0), (3, 0)),
            ((0, 0), (1, 1), (1, 1), (2, 0)), *(tuple(rng.normal(size=(4, 2))) for _ in range(20))]
    assert [tg2d.segments_intersect(*s) for s in segs] == [jg2d.segments_intersect(*s) for s in segs]
    lines = [((0, 0), (1, 0), (0, 1), (1, 0)), ((0, 0), (1, 1), (2, 0), (-1, 1)),
             *(tuple(rng.normal(size=(4, 2))) for _ in range(10))]
    for ln in lines:
        pt, pj = tg2d.line_intersection(*ln), jg2d.line_intersection(*ln)
        assert (pt is None and pj is None) or np.array_equal(pt, pj)
    for p in rng.normal(size=(10, 2)) * 2:
        (qt, tt), (qj, tj) = tg2d.project_point_to_segment(p, (0, 0), (1, 0.5)), jg2d.project_point_to_segment(
            p, (0, 0), (1, 0.5))
        assert np.array_equal(qt, qj) and tt == tj
    poly = np.array([[0, 0], [2, 0], [2, 1], [1, 2], [0, 1]], float)
    pts = rng.uniform(-0.5, 2.5, (200, 2))
    assert np.array_equal(tg2d.point_in_polygon(pts, poly), jg2d.point_in_polygon(pts, poly))
    assert tg2d.point_in_polygon(np.array([1.0, 0.5]), poly) == jg2d.point_in_polygon(np.array([1.0, 0.5]), poly)
    assert tg2d.points_nd(pts) == jg2d.points_nd(pts) and tg2d.points_nd([1.0, 2.0]) == jg2d.points_nd([1.0, 2.0])
    assert tg2d.polygon_area(poly) == jg2d.polygon_area(poly) and tg2d.polygon_area(poly[::-1]) < 0
    assert tg2d.EPS == jg2d.EPS


def test_frustum_matches_jax():
    jc, tc = JCam(**_CAM), TCam(**_CAM)
    T_wc = synthetic.orbit_trajectory(6)[4].astype(np.float32)
    pj = jfr.frustum_planes(jc, jnp.asarray(T_wc), near=0.2, far=5.0)
    pt = tfr.frustum_planes(tc, torch.from_numpy(T_wc), near=0.2, far=5.0)
    assert pt.shape == (6, 4) and np.abs(N(pt) - N(pj)).max() <= 1e-6
    rng = np.random.default_rng(11)
    pts = (rng.uniform(-3, 3, (2000, 3)) + T_wc[:3, 3]).astype(np.float32)
    for margin in (0.0, 0.1):
        ct, cj = tfr.contains(pt, torch.from_numpy(pts), margin), jfr.contains(pj, jnp.asarray(pts), margin)
        assert np.array_equal(N(ct), N(cj)) and 0 < N(ct).sum() < len(pts)
    # the camera's own centre ray is inside between near and far
    centre = T_wc[:3, 3] + 1.0 * T_wc[:3, 2]
    assert bool(tfr.contains(pt, torch.from_numpy(centre.astype(np.float32))))


# ---- the ATE sweep's dense options ------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """Frames 0 and 1 of the 16-frame orbit at 160x120 (the port's render)."""
    tc = TCam(**_CAM)
    poses = synthetic.orbit_trajectory(16)[:2]
    scene = synthetic.default_scene()
    out = [synthetic.render(scene, torch.from_numpy(p), tc.fx, tc.fy, tc.cx, tc.cy, H, W, num_steps=48) for p in poses]
    return [(o[1].numpy(), o[0].numpy()) for o in out], poses


@pytest.mark.parametrize("blur,norm", [(True, True), (False, True), (False, False)])
def test_preprocess_options_match_jax(pair, blur, norm):
    jc, tc = JCam(**_CAM), TCam(**_CAM)
    g, d = pair[0][0]
    pj = jdense.preprocess_frame(jnp.asarray(g), jnp.asarray(d), jc, depth_blur=blur, intensity_norm=norm)
    pt = tdense.preprocess_frame(torch.from_numpy(g), torch.from_numpy(d), tc, depth_blur=blur, intensity_norm=norm)
    for field in ("grays", "depths", "xyzs"):
        for a, b in zip(getattr(pt, field), getattr(pj, field)):
            assert np.abs(N(a) - N(b)).max() <= 1e-6, field
    if norm:
        m = N(pt.depths[0]) > 0
        assert abs(N(pt.grays[0])[m].mean() - 0.5) < 1e-4


def test_pair_norm_tracking_matches_jax_exact(pair):
    jc, tc = JCam(**_CAM), TCam(**_CAM)
    frames, _ = pair
    pj = [jdense.preprocess_frame(jnp.asarray(g), jnp.asarray(d), jc) for g, d in frames]
    pt = [tdense.preprocess_frame(torch.from_numpy(g), torch.from_numpy(d), tc) for g, d in frames]
    for ddm in (0.05, 0.07):
        rj = jdense.dense_tracking_exact(pj[0], pj[1], jc, depth_diff_max=ddm, pair_norm=True)
        rt = tdense.dense_tracking(pt[0], pt[1], tc, depth_diff_max=ddm, pair_norm=True)
        A, B = N(rt.T_ts).astype(np.float64), N(rj.T_ts).astype(np.float64)
        assert np.abs(A[:3, 3] - B[:3, 3]).max() <= 1e-4 and np.abs(A[:3, :3] - B[:3, :3]).max() <= 1e-4
        assert abs(float(rt.rmse) - float(rj.rmse)) <= 1e-4
    # pair normalisation moves the solution (the scales are not 1 on these frames)
    plain = tdense.dense_tracking(pt[0], pt[1], tc, depth_diff_max=0.07)
    assert not torch.equal(plain.T_ts, rt.T_ts)


# ---- the tools ---------------------------------------------------------------------

def test_ransac_tool_exits_0_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(TOOLS.parent))
    proc = subprocess.run([sys.executable, str(TOOLS / "torch_ransac_test.py"), "--n-points", "200", "--device",
                           "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout and "rigid:" in proc.stdout and "homography:" in proc.stdout


def test_ate_sweep_at_80x60_on_4_frames():
    """The sweep's run function over its nine runs, at 80x60 on the first 4
    frames of its orbit: every run tracks (ATE < 50 mm, mean relative
    rotation < 1 deg), and runs C and G (one configuration) agree bit for
    bit. The options' parity with the JAX package is held above."""
    out = torch_ate_sweep.main(["--scale", "8", "--frames", "4", "--device", "cpu"])
    assert [r[0] for r in torch_ate_sweep.RUNS] == list(out)
    for name, (ate, rel_r, _) in out.items():
        assert np.isfinite(ate) and ate < 0.05 and rel_r < 1.0, (name, ate, rel_r)
    assert out["C B + depth blur"][:2] == out["G C + masked zSobel"][:2]
