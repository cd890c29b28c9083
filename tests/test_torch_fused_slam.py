"""The port's dense fusion loop (FusedDenseFusion) against the JAX package's,
at 80x60 on the first 4 frames of the 16-frame orbit, kmax=512, stride=2.
The JAX loop runs its Pallas TSDF kernel in interpret mode and its
production (prewarp + stencil, bf16) tracker; the port tracks in the exact
gather form and integrates like the exact oracle `integrate_blocks`.

Frames are rendered with 48 sphere-tracing steps, as the JAX package's
`tests/test_device_volume.py` renders them for its fusion tests.

Tolerances:
  - per-frame relative poses vs the JAX loop: <= 3 mm and <= 3e-3
    (rotation entries);
  - ATE against ground truth within 1.5 mm of each other;
  - teacher-forced step (both packages from the JAX state after frame 1):
    tracking vs JAX `dense_tracking_exact` from the same state <= 1e-4.
    (From the state after frame 2 the two exact trackers part by 3.6e-4:
    a 2e-7 pose difference flips one of ~3800 inliers at the depth gate of
    the finest level, and the hard gate carries that through 4 iterations);
    integration with the same pose and filtered depth: {block key -> pool
    row} maps on >= 99.5 % shared keys, weights equal to the exact oracle
    and sdf / colour within 1e-6 of it; vs the JAX loop's Pallas-produced
    rows weights equal, sdf < 5e-4, colour < 5e-3 (bf16 split) on every
    voxel where the oracle agrees with the Pallas kernel (all but <= 1e-4
    of them: its transform rounds a few voxels to a neighbouring pixel);
  - the same integration step with an rgb image, against JAX `_integrate`
    with that rgb (Pallas in interpret mode, bf16 `pack_image`) and the
    exact oracle with that rgb: the same tolerances;
  - maybe_grow from the same state: pool and table exactly equal;
  - the port with rgbs (port only, seeded uniform colour): poses, sdf and
    weights bit-equal to its gray run (tracking reads gray only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry import se3 as jse3
from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.integration import device_hash as jdh
from onepiece_tpu.io import trajectory as jtraj
from onepiece_tpu.odometry import dense as jdense
from onepiece_tpu.ops import tsdf as jtsdf
from onepiece_tpu.ops.image import bilateral_filter as jbilateral
from onepiece_tpu.systems import fused_slam as jfs
from onepiece_tpu.utils import synthetic as jsyn
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA as TCAM
from onepiece_tpu_torch.io import trajectory as ttraj
from onepiece_tpu_torch.ops import tsdf as ttsdf
from onepiece_tpu_torch.systems import fused_slam as tfs

N = 4
KW = dict(capacity=2048, table_size=1 << 12, kmax=512, stride=2)
INVALID = ttsdf.INVALID_KEY


@pytest.fixture(scope="module")
def run():
    cam_j, cam_t = JCAM.pyramid(4)[3], TCAM.pyramid(4)[3]
    poses = jsyn.orbit_trajectory(16)[:N]
    scene = jsyn.default_scene()
    frames = [
        jsyn.render(scene, jnp.asarray(p), cam_j.fx, cam_j.fy, cam_j.cx, cam_j.cy,
                    cam_j.height, cam_j.width, num_steps=48)
        for p in poses
    ]
    grays = np.stack([np.array(g) for _, g in frames])
    depths = np.stack([np.array(d) for d, _ in frames])
    rgbs = np.random.default_rng(1).uniform(0, 1, (*grays.shape, 3)).astype(np.float32)

    slam_j = jfs.FusedDenseFusion(cam_j, interpret=True, **KW)
    states = []  # JAX state after each frame, leaves copied to numpy
    for g, d in zip(grays, depths):
        slam_j.process_frame(g, d)
        states.append(jax.tree.map(np.array, slam_j._state))
    est_j, _ = slam_j.finalize()

    slam_t = tfs.FusedDenseFusion(cam_t, device="cpu", **KW)
    slam_t.process_chunk(grays, depths)
    est_t, rmse_t = slam_t.finalize()
    return dict(cam_j=cam_j, cam_t=cam_t, poses=poses, grays=grays, depths=depths, rgbs=rgbs, states=states,
                slam_j=slam_j, est_j=est_j, slam_t=slam_t, est_t=est_t, rmse_t=rmse_t)


def _rel(T):
    return [np.linalg.inv(T[i - 1]) @ T[i] for i in range(1, len(T))]


def test_slice_matches_jax(run):
    est_t, est_j = run["est_t"], run["est_j"]
    assert est_t.shape == (N, 4, 4) and np.isfinite(est_t).all()
    assert np.isfinite(run["rmse_t"]).all()
    for a, b in zip(_rel(est_t), _rel(est_j)):
        assert np.abs(a[:3, 3] - b[:3, 3]).max() <= 3e-3
        assert np.abs(a[:3, :3] - b[:3, :3]).max() <= 3e-3
    ate_t = ttraj.ate_rmse(est_t, run["poses"])
    ate_j = jtraj.ate_rmse(est_j, run["poses"])
    assert abs(ate_t - ate_j) <= 1.5e-3, (ate_t, ate_j)
    assert ate_t < 0.01
    slam_t, slam_j = run["slam_t"], run["slam_j"]
    assert slam_t.overflow == slam_j.overflow == 0
    assert abs(slam_t.num_active - slam_j.num_active) <= 0.02 * slam_j.num_active
    assert slam_t.key_saturated_frames == slam_j.key_saturated_frames
    vol = slam_t.to_volume()
    assert vol.num_active == slam_t.num_active == len(vol.slot_of)
    assert vol.sdf.shape == (KW["capacity"], 8, 8, 8) and vol.color.shape[-1] == 3
    assert float(vol.weight[: vol.num_active].max()) == N


def _block_slots(table):
    """{packed key: pool slot} of every allocated block."""
    tk = np.asarray(table.table_keys)
    ts = np.asarray(table.table_slots)
    ok = (tk != INVALID) & (ts >= 0)
    return dict(zip(tk[ok].tolist(), ts[ok].tolist()))


def test_teacher_forced_step_matches_jax(run):
    k = 1
    ref_k, ref = run["states"][k], run["states"][k + 1]
    gray, depth = run["grays"][k + 1], run["depths"][k + 1]

    # tracking: the port's frame step from the JAX state == JAX's exact tracker
    slam = tfs.FusedDenseFusion(run["cam_t"], device="cpu", **KW)
    slam._state = tfs.state_from_numpy(ref_k, "cpu")
    slam.process_frame(gray, depth)
    pyr = jdense.preprocess_frame(jnp.asarray(gray), jnp.asarray(depth), run["cam_j"])
    exact = jdense.dense_tracking_exact(
        jax.tree.map(jnp.asarray, ref_k.pyr), pyr, run["cam_j"], init_T=jnp.asarray(ref_k.rel))
    assert np.abs(slam._state.rel.numpy() - np.asarray(exact.T_ts)).max() <= 1e-4
    assert np.abs(slam._state.T_w.numpy() - ref.T_w).max() <= 3e-3  # vs the prewarp loop

    # integration from the same state with the JAX loop's pose and filtered depth
    _integration_matches_jax(run, k, None, ref.vox, ref.table)


def test_teacher_forced_rgb_integration_matches_jax(run):
    """The integration step of the teacher-forced test with an rgb image:
    JAX `_integrate(..., rgb, interpret=True)` from the JAX state after frame
    1 against the port's `_integrate(..., rgb)`."""
    k = 1
    ref_k, ref = run["states"][k], run["states"][k + 1]
    depth_f = jbilateral(jnp.asarray(run["depths"][k + 1]))
    vox_j, table_j, _ = jfs._integrate(
        jnp.asarray(ref_k.vox), jax.tree.map(jnp.asarray, ref_k.table), depth_f,
        jnp.asarray(run["grays"][k + 1]), jnp.asarray(run["rgbs"][k + 1]), jnp.asarray(ref.T_w),
        run["cam_j"], 0.0125, 0.1, KW["kmax"], KW["stride"], 100.0, True, tfs.FRAME_CLAIM_ROUNDS,
    )
    _integration_matches_jax(run, k, run["rgbs"][k + 1], np.asarray(vox_j), table_j)


def _integration_matches_jax(run, k, rgb, vox_j, table_j):
    """The port's `_integrate` from the JAX state after frame k, with the JAX
    loop's pose and filtered depth of frame k + 1 and colour from `rgb` (or
    gray), against the exact oracle on the same prior rows and against
    `vox_j` / `table_j`, the JAX package's pool and table after the same step."""
    ref_k, ref = run["states"][k], run["states"][k + 1]
    gray, depth = run["grays"][k + 1], run["depths"][k + 1]
    st = tfs.state_from_numpy(ref_k, "cpu")
    depth_f = np.array(jbilateral(jnp.asarray(depth)))
    table, _ = tfs._integrate(
        st.vox, st.table, torch.from_numpy(depth_f), torch.from_numpy(gray),
        None if rgb is None else torch.from_numpy(rgb),
        torch.from_numpy(ref.T_w), run["cam_t"], 0.0125, 0.1, KW["kmax"], KW["stride"],
        tfs.FRAME_CLAIM_ROUNDS,
    )
    slots_t, slots_j = _block_slots(table), _block_slots(table_j)
    assert len(slots_t.keys() & slots_j.keys()) >= 0.995 * len(slots_t.keys() | slots_j.keys())
    # the blocks both packages integrated this frame (kmax saturates here)
    cam = run["cam_j"]
    touched = [
        set(np.asarray(f(depth_f, ref.T_w, cam.fx, cam.fy, cam.cx, cam.cy, 0.0125, 0.1,
                         max_blocks=KW["kmax"], stride=KW["stride"])).tolist())
        for f in (lambda d, T, *a, **kw: ttsdf.touched_block_keys(torch.from_numpy(d), torch.from_numpy(T), *a, **kw),
                  lambda d, T, *a, **kw: jtsdf.touched_block_keys(jnp.asarray(d), jnp.asarray(T), *a, **kw))
    ]
    keys = sorted((touched[0] & touched[1] & slots_t.keys() & slots_j.keys()) - {INVALID})
    assert len(keys) >= 0.99 * (KW["kmax"] - 1)
    port = st.vox.numpy()[[slots_t[key] for key in keys]]
    rows_j = [slots_j[key] for key in keys]
    pallas = vox_j[rows_j]
    s_o, w_o, c_o = jtsdf.integrate_blocks(  # the exact oracle on the same prior rows
        jnp.asarray(ref_k.vox[rows_j, 0]), jnp.asarray(ref_k.vox[rows_j, 1]),
        jnp.asarray(np.moveaxis(ref_k.vox[rows_j, 2:5], 1, -1)),
        jdh.unpack_keys(jnp.asarray(keys, jnp.int32)), jnp.ones(len(keys), bool),
        jnp.asarray(depth_f), jnp.asarray(np.repeat(gray[..., None], 3, -1) if rgb is None else rgb),
        jse3.inverse_T(jnp.asarray(ref.T_w)), cam.fx, cam.fy, cam.cx, cam.cy, 0.0125, 0.1,
    )
    np.testing.assert_array_equal(port[:, 1], np.asarray(w_o))
    assert np.abs(port[:, 0] - np.asarray(s_o)).max() <= 1e-6
    assert np.abs(np.moveaxis(port[:, 2:5], 1, -1) - np.asarray(c_o)).max() <= 1e-6

    def agrees(w, sdf, col):
        return ((w == pallas[:, 1]) & (np.abs(sdf - pallas[:, 0]) < 5e-4)
                & (np.abs(col - pallas[:, 2:5]).max(axis=1) < 5e-3))

    # the Pallas kernel rounds a few voxels to a neighbouring pixel (no FMA
    # in its transform); the port disagrees with it exactly where the oracle does
    ok = agrees(port[:, 1], port[:, 0], port[:, 2:5])
    np.testing.assert_array_equal(ok, agrees(np.asarray(w_o), np.asarray(s_o), np.moveaxis(np.asarray(c_o), -1, 1)))
    assert (~ok).sum() <= 1e-4 * ok.size
    assert (port[:, 1] == k + 2).sum() > 1000  # blocks seen by every frame so far


def test_maybe_grow_matches_jax(run):
    """Growth from the same state: pool rows keep their slots, the table is
    rebuilt at double size with the same cells as the JAX package's."""
    slam_j = run["slam_j"]
    slam_t = tfs.FusedDenseFusion(run["cam_t"], device="cpu", **KW)
    slam_t._state = tfs.state_from_numpy(run["states"][-1], "cpu")
    slam_t._sat = [torch.tensor(False)]
    assert not slam_t.maybe_grow()  # below the default threshold: nothing to do
    assert slam_t.maybe_grow(threshold=0.1) and slam_j.maybe_grow(threshold=0.1)
    assert slam_t.capacity == slam_j.capacity == 2 * KW["capacity"]
    assert slam_t.table_size == slam_j.table_size == 2 * KW["table_size"]
    sj, st = slam_j._state, slam_t._state
    for name, a, b in zip(sj.table._fields, st.table, sj.table):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(st.vox.numpy(), np.asarray(sj.vox))
    # the grown system keeps running: the next frame re-finds every block
    na = slam_t.num_active
    slam_t.process_frame(run["grays"][-1], run["depths"][-1])
    assert slam_t.overflow == 0 and na <= slam_t.num_active < slam_t.capacity


def test_rgb_run_keeps_the_gray_runs_poses_and_geometry(run):
    """process_chunk with rgbs: tracking reads gray only, so poses, sdf and
    weights are bit-equal to the gray run's; only the colours differ."""
    slam = tfs.FusedDenseFusion(run["cam_t"], device="cpu", **KW)
    slam.process_chunk(run["grays"], run["depths"], run["rgbs"])
    est, _ = slam.finalize()
    np.testing.assert_array_equal(est, run["est_t"])
    vox, vox_gray = slam._state.vox[:-1], run["slam_t"]._state.vox[:-1]
    assert torch.equal(vox[:, :2], vox_gray[:, :2])
    seen = vox[:, 1] > 0
    col = vox[:, 2:5].movedim(1, -1)[seen]
    assert bool(torch.isfinite(col).all()) and float(col.min()) >= 0.0 and float(col.max()) <= 1.0
    assert float((col - vox_gray[:, 2:5].movedim(1, -1)[seen]).abs().max()) > 0.1


def test_to_volume_owns_its_pool(run):
    """Integrating a frame into `to_volume()` leaves the fused loop alone:
    after one more fused frame, its pool and trajectory equal those of a run
    that never exported. (The volume allocates new blocks at slots
    num_active.., rows that the loop's hash table hands out next.)"""
    cam, grays, depths, poses = run["cam_t"], run["grays"], run["depths"], run["poses"]
    T_wc = np.linalg.inv(poses[0]) @ poses[3]
    T_wc[:3, 3] += [0.2, 0.0, 0.0]  # a view that reaches blocks the loop has not seen
    runs = []
    for export in (False, True):
        slam = tfs.FusedDenseFusion(cam, device="cpu", **KW)
        slam.process_chunk(grays[:3], depths[:3])
        if export:
            vol = slam.to_volume()
            na = vol.num_active
            vol.integrate(depths[3], None, T_wc, cam)
            assert vol.num_active > na
        slam.process_frame(grays[3], depths[3])
        runs.append((slam.finalize()[0], slam._state.vox[:-1].clone()))  # the last row is the trash row
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
