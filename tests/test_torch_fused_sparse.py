"""The port's FusedFBASlam (`systems/fused_sparse.py`) against the JAX
package's, on the CPU (plain versions), and its capacity growth.

The slice runs the settings of `tests/test_fused_sparse.py`: the 12-frame
synthetic orbit at 160x120, 500 keypoints, keyframe disparity 10 px, in
chunks of 8 and 4. The JAX run is made once (module fixture, ~16 s on a
CPU). The two packages draw different random numbers, so the slice is held
to the JAX package's accuracy regime, as `tests/test_fused_sparse.py`
holds its host loop against its fused path: ATE < 0.05 m and < max(3 x
the JAX ATE, 0.05 m), keyframes within 2 of the JAX run's, no edge
overflow.
"""

import numpy as np
import pytest
import torch

from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.systems.fused_sparse import FusedFBASlam as JaxFusedFBASlam
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.systems.fused_sparse import FusedFBASlam
from onepiece_tpu_torch.utils import synthetic

CAM = TUM_CAMERA.pyramid(3)[2]  # 160x120
JCAM160 = JCAM.next_pyramid_level().next_pyramid_level()
SETTINGS = dict(max_keypoints=500, keyframe_disparity=10.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs: the test workers share the
    host's cores, and thousands of small operations stall each other's
    thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def seq12():
    poses = synthetic.orbit_trajectory(12)
    scene = synthetic.default_scene()
    out = [synthetic.render(scene, torch.from_numpy(p), CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.height, CAM.width,
                            num_steps=64) for p in poses]
    return np.stack([o[1].numpy() for o in out]), np.stack([o[0].numpy() for o in out]), poses


@pytest.fixture(scope="module")
def runs(seq12):
    """The JAX package's and the port's runs over the same frames."""
    grays, depths, _ = seq12
    jax_slam = JaxFusedFBASlam(JCAM160, **SETTINGS)
    port = FusedFBASlam(CAM, device="cpu", **SETTINGS)
    for s in (jax_slam, port):
        s.process_chunk(grays[:8], depths[:8])
        s.process_chunk(grays[8:], depths[8:])
    return jax_slam, port


def test_fused_sparse_slice_in_the_jax_regime(seq12, runs):
    _, _, poses = seq12
    jax_slam, port = runs
    est = port.trajectory()
    assert est.shape == (12, 4, 4) and np.isfinite(est).all()
    ate_j = traj.ate_rmse(jax_slam.trajectory(), poses)
    ate_t = traj.ate_rmse(est, poses)
    assert ate_t < 0.05 and ate_t < max(3.0 * ate_j, 0.05), (ate_t, ate_j)
    assert port.num_kf >= 3 and abs(port.num_kf - jax_slam.num_kf) <= 2, (port.num_kf, jax_slam.num_kf)
    assert port.edge_overflow == 0 and port.num_edges >= port.num_kf - 1
    # one ladder read per frame, and per chunk: the promotions, the LC pairs, the fetch
    assert port.host_reads <= 12 + 2 * 3


def test_fused_sparse_capacity_grows(seq12):
    grays, depths, _ = seq12
    small = FusedFBASlam(CAM, device="cpu", kf_capacity=2, edge_capacity=4, **SETTINGS)
    info = small.process_chunk(grays[:3], depths[:3])
    # 0 keyframes + 2 x 8 (the padded chunk) + 2 > 2 -> 4, 8, 16, 32; edges 2 x 8 x 8 = 128 -> 128
    assert (small.kf_capacity, small.edge_capacity, small.capacity_doublings) == (32, 128, 9)
    st = small._state
    assert st.kf.kp.desc.shape == (32, 500, 8) and st.kf_pose.shape == (32, 4, 4)
    assert st.edges.p_src.shape == (128, small.corr_capacity, 3) and small.edge_overflow == 0
    assert info["keyframes"] >= 1
    ref = FusedFBASlam(CAM, device="cpu", **SETTINGS)
    ref.process_chunk(grays[:3], depths[:3])
    assert ref.num_kf == small.num_kf and ref.num_edges == small.num_edges
    # the pose graph's system is larger, so its sums may round differently
    assert np.abs(small.trajectory() - ref.trajectory()).max() < 1e-4
