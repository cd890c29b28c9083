"""The port's checkpoint and resume (`onepiece_tpu_torch/utils/checkpoint.py`)
on the CPU, and its file format against the JAX package's.

The port runs alone on the sequence of `tests/test_checkpoint.py`, the
12-frame synthetic orbit, cut to its first frames: 80x60 for
`FusedDenseFusion` (4 + 4 frames), 160x120 for `FusedFBASlam` after
capacity growth (500 keypoints, every frame a keyframe, capacities 8
keyframes / 16 edges, 4 + 2 frames) and for `FusedBASlam` (500 keypoints,
disparity 10 px, 1,024 points / 2,048 observations, 4 LM iterations, 4 + 2
frames; BA runs in both chunks). Each system runs its first
chunk, is saved, and runs its second chunk; a fresh instance loaded from
the file runs the same second chunk. Poses, every state leaf and the host
records must be bit-equal. (Saving reads the state and changes nothing; the
dense reference is a separate uninterrupted run all the same.)

Cross-format, both ways, with no JAX kernel run: the JAX package's
`checkpoint.load` reads each port file, its `checkpoint.save` writes it
again, and the port loads that file: every leaf, the host lists and the RNG
state must be bit-equal to the port's state at the save.

Torch is pinned to one intra-op thread while the module runs (the test
workers share the host's cores).
"""

import copy

import numpy as np
import pytest
import torch

from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.utils import checkpoint as jckpt
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.systems.fused_ba import FusedBASlam
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
from onepiece_tpu_torch.systems.fused_sparse import FusedFBASlam
from onepiece_tpu_torch.utils import checkpoint, synthetic

CAM80, JCAM80 = TUM_CAMERA.pyramid(4)[3], JCAM.pyramid(4)[3]
CAM160, JCAM160 = TUM_CAMERA.pyramid(3)[2], JCAM.pyramid(3)[2]
DENSE = dict(capacity=2048, table_size=1 << 13, kmax=1024)
SPARSE = dict(max_keypoints=500, keyframe_disparity=1e-6, kf_capacity=8, edge_capacity=16)
BA = dict(max_keypoints=500, keyframe_disparity=10.0, pt_capacity=1024, obs_capacity=2048, ba_iters=4)
HOST_LISTS = ("frame_count", "num_kf", "num_edges", "edge_overflow", "lc_edges_total", "kf_capacity",
              "edge_capacity", "_anchors", "_ok", "_iskf")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def render(cam, n: int):
    """The first n frames of the 12-frame orbit."""
    scene = synthetic.default_scene()
    out = [synthetic.render(scene, torch.from_numpy(p), cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width,
                            num_steps=64) for p in synthetic.orbit_trajectory(12)[:n]]
    return torch.stack([g for _, g in out]), torch.stack([d for d, _ in out])


def state_of(slam):
    return (slam._state, slam._track_state) if isinstance(slam, FusedBASlam) else slam._state


def snapshot(slam) -> dict:
    """Copies of every state leaf and of the host records, as they are now."""
    snap = {"leaves": [t.clone() for _, t in checkpoint._leaves(state_of(slam))]}
    if isinstance(slam, FusedDenseFusion):
        snap.update(poses=torch.stack(slam._poses).clone(), rmses=torch.stack(slam._rmses).clone(),
                    frame_count=slam.frame_count)
    else:
        snap.update({k: copy.copy(getattr(slam, k)) for k in HOST_LISTS}, trels=np.stack(slam._Trels),
                    kf_pose=slam._kf_pose.copy(), rng=slam._rng.bit_generator.state)
    return snap


def assert_same(slam, snap) -> None:
    leaves = [t for _, t in checkpoint._leaves(state_of(slam))]
    assert len(leaves) == len(snap["leaves"])
    for i, (a, b) in enumerate(zip(leaves, snap["leaves"])):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    if isinstance(slam, FusedDenseFusion):
        assert slam.frame_count == snap["frame_count"]
        assert torch.equal(torch.stack(slam._poses), snap["poses"])
        assert torch.equal(torch.stack(slam._rmses), snap["rmses"])
    else:
        assert {k: getattr(slam, k) for k in HOST_LISTS} == {k: snap[k] for k in HOST_LISTS}
        assert np.array_equal(np.stack(slam._Trels), snap["trels"])
        assert np.array_equal(slam._kf_pose, snap["kf_pose"])
        assert slam._rng.bit_generator.state == snap["rng"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per system: the first chunk, the save (with a snapshot of the state
    at the save), the second chunk; and a fresh instance resumed from the
    file over the same second chunk."""
    out = {}
    d = tmp_path_factory.mktemp("ckpt")
    g80, d80 = render(CAM80, 8)
    g160, d160 = render(CAM160, 6)
    cases = (
        ("dense", lambda: FusedDenseFusion(CAM80, device="cpu", **DENSE), CAM80, g80, d80, 4),
        ("sparse", lambda: FusedFBASlam(CAM160, device="cpu", **SPARSE), CAM160, g160, d160, 4),
        ("ba", lambda: FusedBASlam(CAM160, device="cpu", **BA), CAM160, g160, d160, 4),
    )
    for name, make, cam, grays, depths, k in cases:
        a = make()
        a.process_chunk(grays[:k], depths[:k])
        path = str(d / f"{name}.npz")
        checkpoint.save(a, path)
        snap = snapshot(a)
        if name == "dense":  # a separate uninterrupted run
            a = make()
            a.process_chunk(grays[:k], depths[:k])
        a.process_chunk(grays[k:], depths[k:])
        b = checkpoint.load(path, cam, device="cpu")
        assert b.frame_count == k
        b.process_chunk(grays[k:], depths[k:])
        out[name] = dict(ref=a, resumed=b, path=path, snap=snap, cam=cam)
    return out


@pytest.mark.parametrize("name", ["dense", "sparse", "ba"])
def test_resume_is_bit_identical(runs, name):
    r = runs[name]
    a, b = r["ref"], r["resumed"]
    if name == "dense":
        assert np.array_equal(b.finalize()[0], a.finalize()[0])
        assert np.array_equal(b.finalize()[1], a.finalize()[1])
        assert b.num_active == a.num_active > 0
    else:
        assert np.array_equal(b.trajectory(), a.trajectory())
        assert (b.num_kf, b.num_edges) == (a.num_kf, a.num_edges)
    assert_same(b, snapshot(a))
    if name == "sparse":
        assert a.kf_capacity > SPARSE["kf_capacity"] and a.edge_capacity > SPARSE["edge_capacity"]  # grew
    if name == "ba":
        assert b.n_pts == a.n_pts > 0 and b.n_obs == a.n_obs and b.ba_mse == a.ba_mse > 0


@pytest.mark.parametrize("name", ["dense", "sparse", "ba"])
def test_jax_reads_and_rewrites_a_port_checkpoint(runs, name, tmp_path):
    """Port file -> JAX load -> JAX save -> port load: bit-equal to the port's
    state at the save. The JAX package builds its state from the leaves
    (shapes asserted leaf by leaf) and runs no kernel."""
    r = runs[name]
    jcam = JCAM80 if name == "dense" else JCAM160
    jslam = jckpt.load(r["path"], jcam)
    assert jslam.frame_count == r["snap"]["frame_count"]
    again = str(tmp_path / "again.npz")
    jckpt.save(jslam, again)
    assert_same(checkpoint.load(again, r["cam"], device="cpu"), r["snap"])
    with np.load(r["path"]) as ours, np.load(again) as theirs:
        leaves = sorted(k for k in ours.files if k.startswith("leaf"))
        assert leaves == sorted(k for k in theirs.files if k.startswith("leaf"))
        for k in leaves:  # written in the JAX package's dtypes
            assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k
