"""The port's DenseSlam against the JAX package's, on the CPU.

Both run the 12-frame orbit at 80x60 (fx = fy = 50) with submap_size=4:
three submaps, ICP for submaps 1 and 2, one RANSAC attempt (2 against 0)
and the pose graph. JAX tracks with its production prewarp tracker, the
port with the exact gather form (ROADMAP queue 3), so their trajectories
differ by the tracker gap. Tolerances:
  - the slice: the same number of submaps, `icp_ok` flags and edges; both
    ATEs <= 10 mm (tests/test_systems.py's bound) and within 3 mm of each
    other;
  - a teacher-forced step: `state_from_numpy` of the JAX state just before
    submap 2 is finished, then `_finish_submap(2)` in both. The compacted
    cloud counts equal; the ICP pose to 1e-4; `register` with the JAX
    package's sample indices fed in to 1e-3; the optimised submap poses to
    1e-4.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry.camera import PinholeCamera as JCam
from onepiece_tpu.io import trajectory as jtraj
from onepiece_tpu.registration import global_reg as jgr
from onepiece_tpu.systems import dense_slam as jds
from onepiece_tpu.utils import synthetic as jsyn
from onepiece_tpu_torch.geometry.camera import PinholeCamera as TCam
from onepiece_tpu_torch.io import trajectory as ttraj
from onepiece_tpu_torch.registration import global_reg as tgr
from onepiece_tpu_torch.systems import dense_slam as tds
from test_torch_registration import jax_register_samples

CAM = dict(fx=50.0, fy=50.0, cx=39.5, cy=29.5, width=80, height=60, depth_scale=1000.0)
N_FRAMES = 12
SUBMAP = 4

_STATE = ("submap_size", "voxel_size", "icp_threshold", "frame_count", "prev_pyramid")
_LISTS = ("poses", "submap_base", "submap_poses", "rel_in_submap", "frame_submap", "submap_clouds",
          "submap_features", "_pending_clouds")


def _snapshot(slam):
    """The JAX DenseSlam's state as it stands (its arrays are immutable;
    the lists it appends to or rebinds are copied)."""
    snap = {name: getattr(slam, name) for name in _STATE}
    snap.update({name: list(getattr(slam, name)) for name in _LISTS})
    snap["edges"] = [dict(e) for e in slam.edges]
    return types.SimpleNamespace(**snap)


@pytest.fixture(scope="module")
def run():
    poses = jsyn.orbit_trajectory(N_FRAMES)
    scene = jsyn.default_scene()
    c = JCam(**CAM)
    frames = [jsyn.render(scene, jnp.asarray(p), c.fx, c.fy, c.cx, c.cy, c.height, c.width, num_steps=64)
              for p in poses]
    grays = np.stack([np.array(g) for _, g in frames])
    depths = np.stack([np.array(d) for d, _ in frames])

    slam_j = jds.DenseSlam(c, submap_size=SUBMAP)
    before = {}  # JAX state just before submap 2 is finished, and before frame 8
    finish = slam_j._finish_submap

    def spy(sm_idx):
        before[sm_idx] = _snapshot(slam_j)
        return finish(sm_idx)

    slam_j._finish_submap = spy
    for i, (g, d) in enumerate(zip(grays, depths)):
        if i == 8:
            before["frame 8"] = _snapshot(slam_j)
        slam_j.update_frame(g, d)

    slam_t = tds.DenseSlam(TCam(**CAM), "cpu", submap_size=SUBMAP)
    for g, d in zip(grays, depths):
        slam_t.update_frame(g, d)
    return dict(poses=poses, grays=grays, depths=depths, slam_j=slam_j, slam_t=slam_t, before=before)


def _flags(slam):
    return [m["icp_ok"] for m in slam.metrics if "icp_ok" in m]


def test_dense_slam_matches_jax(run):
    slam_j, slam_t = run["slam_j"], run["slam_t"]
    est_t, est_j = slam_t.trajectory(), slam_j.trajectory()
    assert est_t.shape == (N_FRAMES, 4, 4) and np.isfinite(est_t).all()
    assert len(slam_t.submap_poses) == len(slam_j.submap_poses) == 3
    assert _flags(slam_t) == _flags(slam_j) == [False, True, True]
    assert len(slam_t.edges) == len(slam_j.edges)
    assert [(e["src"], e["dst"]) for e in slam_t.edges] == [(e["src"], e["dst"]) for e in slam_j.edges]
    ate_t = ttraj.ate_rmse(est_t, run["poses"])
    ate_j = jtraj.ate_rmse(est_j, run["poses"])
    assert ate_t <= 0.01 and ate_j <= 0.01, (ate_t, ate_j)
    assert abs(ate_t - ate_j) <= 3e-3, (ate_t, ate_j)
    counts_t = [int(c.count()) for c in slam_t.submap_clouds]
    counts_j = [int(c.count()) for c in slam_j.submap_clouds]
    assert all(abs(a - b) <= 0.02 * b for a, b in zip(counts_t, counts_j)), (counts_t, counts_j)
    assert all(c.capacity == 8192 for c in slam_t.submap_clouds)


def _edge_T(edge) -> np.ndarray:
    """The rigid transform an edge was made with (p_dst = R p_src + t),
    recovered by least squares in float64."""
    p = np.c_[edge["p_src"].astype(np.float64), np.ones(len(edge["p_src"]))]
    X = np.linalg.lstsq(p, edge["p_dst"].astype(np.float64), rcond=None)[0]
    out = np.eye(4)
    out[:3, :3], out[:3, 3] = X[:3].T, X[3]
    return out


def test_teacher_forced_finish_submap_matches_jax(run, monkeypatch):
    slam_j = run["slam_j"]
    state = run["before"][2]
    slam_t = tds.state_from_numpy(state, TCam(**CAM), "cpu")
    assert slam_t.frame_count == N_FRAMES and len(slam_t._pending_clouds) == 2
    assert len(slam_t.submap_clouds) == 2 and len(slam_t.edges) == 1

    # register 2 -> 0 with the sample indices the JAX package drew
    params_j = jgr.RansacParams(voxel_size=slam_j.voxel_size)
    fj2, fj0 = slam_j.submap_features[2], slam_j.submap_features[0]
    samples = jax_register_samples(fj2, fj0, params_j)
    registered = []
    register = tgr.register

    def fed(src, tgt, params, **kw):
        registered.append(register(src, tgt, params, samples=samples, **kw))
        return registered[-1]

    monkeypatch.setattr(tds.global_reg, "register", fed)
    info = slam_t._finish_submap(2)
    metrics_j = [m for m in slam_j.metrics if m.get("submap_registered") == 2][0]
    assert info["icp_ok"] == metrics_j["icp_ok"] is True
    assert info["loops"] == metrics_j["loops"]

    assert int(slam_t.submap_clouds[2].count()) == int(slam_j.submap_clouds[2].count())
    assert slam_t.submap_clouds[2].capacity == slam_j.submap_clouds[2].capacity
    icp_t = [e for e in slam_t.edges if (e["src"], e["dst"]) == (2, 1)][0]
    icp_j = [e for e in slam_j.edges if (e["src"], e["dst"]) == (2, 1)][0]
    np.testing.assert_allclose(icp_t["p_src"], icp_j["p_src"], atol=1e-5)
    # 2e-4, not 1e-4: ICP's hard inlier gate is discontinuous, and one of
    # ~5,670 pairs lies at the 0.1 m threshold where JAX's expansion-form
    # distance and nn1's difference form fall on either side of it
    np.testing.assert_allclose(_edge_T(icp_t), _edge_T(icp_j), atol=2e-4)

    rj = jgr.register(fj2, fj0, params_j)
    assert len(registered) == 1
    rt = registered[0]
    assert bool(rt.success) == bool(rj.success)
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-3)

    assert len(slam_t.edges) == len(slam_j.edges)
    np.testing.assert_allclose(np.stack(slam_t.submap_poses), np.stack(slam_j.submap_poses), atol=1e-4)
    np.testing.assert_allclose(slam_t.trajectory(), slam_j.trajectory(), atol=1e-4)


def test_state_from_numpy_continues_the_run(run):
    """From the JAX state after submap 1 the port tracks frame 8 on from
    the carried pyramid and pose chain, within the tracker gap (3 mm) of
    the JAX package's frame 8."""
    state = run["before"]["frame 8"]
    slam_t = tds.state_from_numpy(state, TCam(**CAM), "cpu")
    for name in ("submap_base", "frame_submap", "frame_count"):
        assert getattr(slam_t, name) == getattr(state, name)
    np.testing.assert_array_equal(np.stack(slam_t.poses), np.stack([np.asarray(p) for p in state.poses]))
    assert torch.equal(slam_t.prev_pyramid.depths[0], torch.from_numpy(np.asarray(state.prev_pyramid.depths[0])))
    assert len(slam_t.submap_clouds) == 2 and not slam_t._pending_clouds
    out = slam_t.update_frame(run["grays"][8], run["depths"][8])
    assert out["submap"] == 2 and slam_t.submap_base == [0, 4, 8]
    assert slam_t._pending_clouds[0].capacity == CAM["width"] * CAM["height"]
    T_j = run["before"][2].poses[8]  # frame 8 as JAX tracked it, before the last re-anchoring
    assert np.abs(slam_t.poses[8] - T_j)[:3].max() <= 3e-3
