"""The port's BAFusion (`systems/fused_ba.py`) against the JAX package's, on
the CPU (plain versions).

- The linker: `_link_edge` over a seeded edge store whose edges repeat a
  destination keypoint (the matcher's ratio test is not mutual), hold an
  edge past the count, and overflow the point or the observation capacity.
  The track state must equal the JAX package's: integers exactly, copied
  floats bit for bit (the linker only moves them).
- The slice: `FusedBASlam` at `tests/test_fused_ba.py`'s settings (the
  12-frame 160x120 orbit, 500 keypoints, disparity 10 px, capacities 2048
  points / 4096 observations, 6 LM iterations, chunks of 8 and 4). The two
  packages draw different random numbers, so the slice is held to the JAX
  run's accuracy regime, as `tests/test_torch_fused_sparse.py` holds the
  front end: ATE < 0.05 m and < max(3 x the JAX ATE, 0.05 m), keyframes
  within 2 of the JAX run's, BA's mean squared error < 1e-3 (sigma units),
  no overflow, the track-store invariants of `tests/test_fused_ba.py`, and
  exactly as many host reads as `FusedFBASlam` makes on the same chunks.
  The JAX run is made once (module fixture).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.systems import fused_ba as jfba
from onepiece_tpu.systems import fused_sparse as jfs
from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.systems import fused_ba as tfba
from onepiece_tpu_torch.systems import fused_sparse as tfs
from test_torch_fused_sparse import CAM, JCAM160, seq12, two_chunks  # noqa: F401  (the 12-frame orbit fixture)

SETTINGS = dict(max_keypoints=500, keyframe_disparity=10.0, pt_capacity=2048, obs_capacity=4096, ba_iters=6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs: the test workers share the
    host's cores, and thousands of small operations stall each other's
    thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_edges(seed: int = 4, n_cap: int = 6, f: int = 40, c: int = 16, e_cap: int = 6, num: int = 4):
    """Edges 0-1, 1-2, 0-2, 2-3 (num = 4) and a fifth past the count, each
    with distinct source keypoints and destination keypoints drawn from a
    narrow range, so that a destination repeats within an edge."""
    rng = np.random.default_rng(seed)
    src = np.array([0, 1, 0, 2, 3, 0][:e_cap])
    dst = np.array([1, 2, 2, 3, 4, 0][:e_cap])
    src_i = np.stack([rng.permutation(f)[:c] for _ in range(e_cap)])
    dst_j = rng.integers(0, f // 2, (e_cap, c))
    dst_j[0, 3] = dst_j[0, 1]  # a repeat, both matches valid
    valid = rng.uniform(size=(e_cap, c)) < 0.8
    valid[0, [1, 3]] = True
    p_src = rng.normal(size=(e_cap, c, 3)).astype(np.float32)
    p_dst = rng.normal(size=(e_cap, c, 3)).astype(np.float32)
    kf_uv = rng.uniform(0, 160, (n_cap, f, 2)).astype(np.float32)
    return dict(src=src, dst=dst, p_src=p_src, p_dst=p_dst, valid=valid, src_i=src_i, dst_j=dst_j,
                num=num, kf_uv=kf_uv, n_cap=n_cap, f=f)


@pytest.mark.parametrize("p_cap,o_cap", [(24, 48), (64, 40)])
def test_link_edges_match_jax(p_cap, o_cap):
    ed = seeded_edges()
    j_edges = jfs.EdgeStore(
        *(jnp.asarray(ed[k], jnp.int32 if ed[k].dtype.kind == "i" else None)
          for k in ("src", "dst", "p_src", "p_dst", "valid", "src_i", "dst_j")),
        num=jnp.int32(ed["num"]), overflow=jnp.int32(0))
    ts_j = jfba.make_track_state(ed["n_cap"], ed["f"], p_cap, o_cap)
    kf_pose = jnp.tile(jnp.eye(4), (ed["n_cap"], 1, 1))
    for e in range(ed["num"]):
        ts_j = jfba._link_edge(e, ts_j, j_edges, kf_pose, jnp.asarray(ed["kf_uv"]))
    ts_j = jax.device_get(ts_j)

    t_edges = tfs.EdgeStore(
        *(torch.from_numpy(np.asarray(ed[k])) for k in ("src", "dst", "p_src", "p_dst", "valid", "src_i", "dst_j")),
        num=torch.tensor(ed["num"]), overflow=torch.tensor(0))
    ts_t = tfba.make_track_state(ed["n_cap"], ed["f"], p_cap, o_cap)
    # the host's bound covers the fifth edge, past the count: it must change nothing
    ts_t = tfba.link_edges(ts_t, t_edges, torch.from_numpy(ed["kf_uv"]), bound=ed["num"] + 1)

    assert int(ts_t.linked_edges) == ed["num"]
    for name in tfba.TrackState._fields:
        if name == "linked_edges":  # JAX sets it after its loop
            continue
        a, b = getattr(ts_t, name).numpy(), np.asarray(getattr(ts_j, name))
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
        else:
            assert np.array_equal(a, b.astype(np.int64)), name
    # the case this runs: a repeated destination keypoint, a point overflow
    assert int(ts_t.n_pts) == p_cap or int(ts_t.pt_overflow) == 0
    if p_cap == 24:
        assert int(ts_t.pt_overflow) > 0
    else:
        assert int(ts_t.obs_overflow) > 0


@pytest.fixture(scope="module")
def runs(seq12):  # noqa: F811
    """The JAX package's and the port's FusedBASlam runs over the same
    frames, and the port's FusedFBASlam, each port run with its sync counts."""
    grays, depths, _ = seq12
    jax_slam = jfba.FusedBASlam(JCAM160, **SETTINGS)
    port = tfba.FusedBASlam(CAM, device="cpu", **SETTINGS)
    fba = tfs.FusedFBASlam(CAM, device="cpu", max_keypoints=500, keyframe_disparity=10.0)
    jax_slam.process_chunk(grays[:8], depths[:8])
    jax_slam.process_chunk(grays[8:], depths[8:])
    return jax_slam, (port, two_chunks(port, grays, depths)), (fba, two_chunks(fba, grays, depths))


def test_fused_ba_slice_in_the_jax_regime(seq12, runs):  # noqa: F811
    _, _, poses = seq12
    jax_slam, (port, port_syncs), (_, fba_syncs) = runs
    est = port.trajectory()
    assert est.shape == (12, 4, 4) and np.isfinite(est).all()
    ate_j = traj.ate_rmse(jax_slam.trajectory(), poses)
    ate_t = traj.ate_rmse(est, poses)
    assert ate_t < 0.05 and ate_t < max(3.0 * ate_j, 0.05), (ate_t, ate_j)
    assert port.num_kf >= 3 and abs(port.num_kf - jax_slam.num_kf) <= 2, (port.num_kf, jax_slam.num_kf)
    assert port.ba_mse < 1e-3, port.ba_mse
    assert port.pt_overflow == 0 and port.obs_overflow == 0 and port.edge_overflow == 0
    assert port.n_pts > 50 and port.n_obs > 2 * port.n_pts * 0.8, (port.n_pts, port.n_obs)
    # BA adds no host read to the front end's
    reads = ("sync.ladder", "sync.promotions", "sync.lc_pairs", "sync.chunk_fetch")
    assert [port_syncs.get(k) for k in reads] == [fba_syncs.get(k) for k in reads], (port_syncs, fba_syncs)
    assert set(port_syncs) <= {*reads, "sync.kabsch_svd"}, port_syncs


def test_fused_ba_track_store_invariants(runs):
    _, (port, _), _ = runs
    ts = port._track_state
    n_obs, n_pts = int(ts.n_obs), int(ts.n_pts)
    assert 0 < n_pts <= port.pt_capacity and 0 < n_obs <= port.obs_capacity
    obs_point, obs_frame = ts.obs_point[:n_obs].numpy(), ts.obs_frame[:n_obs].numpy()
    assert (obs_point >= 0).all() and (obs_point < n_pts).all()
    assert (obs_frame >= 0).all() and (obs_frame < port.num_kf).all()
    assert (np.bincount(obs_point, minlength=n_pts) >= 1).all()  # every point is born with an observation
    assert int(ts.track_of_kp[: port.num_kf].max()) < n_pts
    assert int(ts.linked_edges) == port.num_edges


def test_fused_ba_capacity_grows(seq12):  # noqa: F811
    """Point and observation capacities double between chunks, keyframe rows
    of the track map with the keyframe capacity (from 64 / 128)."""
    grays, depths, poses = seq12
    slam = tfba.FusedBASlam(CAM, device="cpu", max_keypoints=500, keyframe_disparity=5.0, pt_capacity=64,
                            obs_capacity=128, ba_iters=2, kf_capacity=8)
    for i in range(0, 8, 4):  # the first chunk fills both capacities; the second runs after the growth
        slam.process_chunk(grays[i : i + 4], depths[i : i + 4])
    ts = slam._track_state
    assert slam.pt_capacity > 64 and slam.obs_capacity > 128 and slam.kf_capacity > 8
    assert ts.pt_local.shape == (slam.pt_capacity, 3) and ts.pt_anchor.shape == (slam.pt_capacity,)
    assert ts.obs_pc.shape == (slam.obs_capacity, 3) and ts.obs_uv.shape == (slam.obs_capacity, 2)
    assert ts.track_of_kp.shape == (slam.kf_capacity, 500) and (ts.track_of_kp[slam.num_kf:] == -1).all()
    assert traj.ate_rmse(slam.trajectory(), poses[:8]) < 0.06
