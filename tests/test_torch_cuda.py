"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: a CUDA kernel has no CPU or interpret mode, so these skip on
a machine without a CUDA device. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(`tests/conftest.py` imports JAX, which the card's machine does not have.)

Tolerances: TSDF weights equal, sdf and colour <= 1e-5 (gray and rgb
images); normal equations
relative 1e-4 of the largest entry, inlier count equal; one Gauss-Newton
step (normal equations, 6x6 solve, se3_exp update in one launch) inliers
equal and T within 1e-5 (sums in another order, sinf / cosf against
torch's); a whole 3-level tracking, kernel route against the plain route on
the card, within 1e-3 (the hard depth gate can flip an inlier and carry a
2e-7 difference to ~4e-4); nn1 indices equal and squared distances
bit-equal (same expression, same order). The kernels are
built without implicit FMA contraction (the TSDF transform's FMAs are
explicit, and its plain version makes the same ones), so per-element
arithmetic rounds as the plain versions' does and only the order of the
normal equations' sums differs.
"""

import numpy as np
import pytest
import torch

from onepiece_tpu_torch import _build
from onepiece_tpu_torch.geometry import se3
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.integration import device_hash as dh
from onepiece_tpu_torch.odometry import dense
from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.ops import dense_odometry as dops
from onepiece_tpu_torch.ops import nn1 as nn1_ops
from onepiece_tpu_torch.ops import tsdf as tsdf_ops
from onepiece_tpu_torch.ops import tsdf_slots
from onepiece_tpu_torch.registration import icp
from onepiece_tpu_torch.systems.dense_slam import DenseSlam
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
from onepiece_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

CAM = TUM_CAMERA.pyramid(3)[2]  # 160x120


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _build.library()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frames(dev):
    poses = synthetic.orbit_trajectory(16)[:4]
    scene = synthetic.default_scene(dev)
    out = [synthetic.render(scene, torch.from_numpy(p).to(dev), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                            CAM.height, CAM.width, num_steps=64) for p in poses]
    return poses, torch.stack([g for _, g in out]), torch.stack([d for d, _ in out])


def _rgb(frames, i, dev):
    """Seeded uniform (H, W, 3) colour for frame i."""
    h, w = frames[1].shape[1:]
    return torch.from_numpy(np.random.default_rng(i).uniform(0, 1, (h, w, 3)).astype(np.float32)).to(dev)


def _tsdf_inputs(dev, frames, form):
    """A 4096-block pool with random prior content, frame 2's keys and slots
    (K = 2048) and its image in the form's layout."""
    poses, grays, depths = frames
    T_w = torch.from_numpy(np.linalg.inv(poses[0]) @ poses[2]).to(dev)
    keys = tsdf_ops.touched_block_keys(depths[2], T_w, CAM.fx, CAM.fy, CAM.cx, CAM.cy, 0.0125, 0.1,
                                       max_blocks=2048, stride=2)
    table, slots = dh.insert(dh.make_table(1 << 13, 4096, dev), keys, claim_rounds=12)
    slots = torch.where(slots < 0, 4096, slots).to(torch.int32)
    gen = torch.Generator(device="cpu").manual_seed(0)
    pool = tsdf_slots.make_pool(4096, dev)
    pool[:, 1] = torch.randint(0, 3, (4097, 512), generator=gen).float().to(dev)
    pool[:, 0] = torch.rand((4097, 512), generator=gen).to(dev) * 2 - 1
    pool[:, 2:5] = torch.rand((4097, 3, 512), generator=gen).to(dev)
    img = (torch.stack([depths[2], grays[2]]) if form == "gray"
           else torch.cat([depths[2][None], _rgb(frames, 2, dev).permute(2, 0, 1)]))
    return pool, keys, slots, (img, se3.inverse_T(T_w), CAM.fx, CAM.fy, CAM.cx, CAM.cy, 0.0125, 0.1)


def _kernel_vs_plain(pool, keys, slots, rest, launched=1):
    before = _build.TSDF_INTEGRATE.launches
    vk = tsdf_slots.integrate_slots(pool.clone(), keys, slots, *rest)
    vp = tsdf_slots.integrate_slots_reference(pool.clone(), keys, slots, *rest)
    torch.cuda.synchronize()
    assert _build.TSDF_INTEGRATE.launches == before + launched
    b = pool.shape[0] - 1  # the trash row holds garbage by design
    assert torch.equal(vk[:b, 1], vp[:b, 1])
    assert float((vk[:b] - vp[:b]).abs().max()) <= 1e-5
    return vk


@pytest.mark.parametrize("form", ["gray", "rgb"])
def test_tsdf_integrate_kernel_matches_plain(dev, frames, form):
    pool, keys, slots, rest = _tsdf_inputs(dev, frames, form)
    n = int((keys != tsdf_ops.INVALID_KEY).sum())
    assert n > 600
    slots[:2] = torch.tensor([-3, 4097 + 5])  # outside the pool: both versions skip them
    # padding keys and out-of-pool slots in the middle of the real entries too
    keys[[n // 5, n // 2, n - 1]] = tsdf_ops.INVALID_KEY
    slots[[n // 3, n // 3 + 1, 2 * n // 3]] = torch.tensor([-1, 4097, 1 << 20], dtype=torch.int32, device=dev)
    vk = _kernel_vs_plain(pool, keys, slots, rest)
    assert int((vk[:4096, 1] != pool[:4096, 1]).sum()) > 10000
    assert torch.equal(vk[4096], pool[4096])  # padding keys leave the trash row alone
    skipped = slots[[0, 1, n // 3, n // 3 + 1, 2 * n // 3]]
    assert not bool(((skipped >= 0) & (skipped <= 4096)).any())
    for i in (n // 5, n // 2, n - 1):  # a padded entry's row is not touched
        assert torch.equal(vk[slots[i]], pool[slots[i]])
    if form == "rgb":  # the colour channels took the rgb, not the depth's neighbour
        gray = tsdf_slots.integrate_slots(pool.clone(), keys, slots, torch.stack([rest[0][0], frames[1][2]]),
                                          *rest[1:])
        assert torch.equal(vk[:4096, :2], gray[:4096, :2])
        assert float((vk[:4096, 2:] - gray[:4096, 2:]).abs().max()) > 0.1


@pytest.mark.parametrize("size", ["below_the_grid", "empty", "k16384", "weight_zero"])
def test_tsdf_integrate_kernel_sizes(dev, frames, size):
    """K smaller than the persistent grid, K = 0 (no launch), the main
    path's keys padded to K = 16,384 (after `maybe_grow` doubles kmax), and
    a pool whose weights are all 0 under random sdf and colour (the kernel
    reads no old sdf or colour where a whole float4 group updates with
    weight 0, and keeps them where a voxel of the group does not update)."""
    pool, keys, slots, rest = _tsdf_inputs(dev, frames, "gray")
    n = int((keys != tsdf_ops.INVALID_KEY).sum())
    if size == "weight_zero":
        pool[:, 1] = 0.0
    if size == "below_the_grid":
        keys, slots = keys[n // 2: n // 2 + 5].clone(), slots[n // 2: n // 2 + 5].clone()
    elif size == "empty":
        keys, slots = keys[:0], slots[:0]
    else:
        pad = 16384 - keys.shape[0]
        keys = torch.cat([keys, torch.full((pad,), tsdf_ops.INVALID_KEY, dtype=torch.int32, device=dev)])
        slots = torch.cat([slots, torch.full((pad,), 4096, dtype=torch.int32, device=dev)])
    vk = _kernel_vs_plain(pool, keys, slots, rest, launched=0 if size == "empty" else 1)
    changed = int((vk[:4096, 1] != pool[:4096, 1]).sum())
    assert changed == 0 if size == "empty" else changed > 100


def test_normal_eq_kernel_matches_plain(dev, frames):
    _, grays, depths = frames
    src = dense.preprocess_frame(grays[0], depths[0], CAM)
    tgt = dense.preprocess_frame(grays[1], depths[1], CAM)
    T = se3.se3_exp(torch.tensor([0.004, -0.003, 0.006, 0.004, -0.006, 0.003], device=dev))
    for li, c in enumerate(CAM.pyramid(3)):
        pts = src.xyzs[li].reshape(-1, 3)
        args = (T, pts, src.grays[li].reshape(-1), pts[:, 2] > 0,
                dops.build_term_data(tgt.grays[li], tgt.depths[li], dense.SOBEL_SCALE),
                c.fx, c.fy, c.cx, c.cy, 0.5, 0.05)
        nk = dops.normal_equations(*args)
        npl = dops.normal_equations_reference(*args)
        assert float(nk.num_inliers) == float(npl.num_inliers) > 100
        for a, b in zip(nk[:3], npl[:3]):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        assert torch.allclose(nk.JTJ, nk.JTJ.T)


def _gn_args(frames, li, T):
    _, grays, depths = frames
    src = dense.preprocess_frame(grays[0], depths[0], CAM)
    tgt = dense.preprocess_frame(grays[1], depths[1], CAM)
    c = CAM.pyramid(3)[li]
    pts = src.xyzs[li].reshape(-1, 3)
    return (T, pts, src.grays[li].reshape(-1), pts[:, 2] > 0,
            dops.build_term_data(tgt.grays[li], tgt.depths[li], dense.SOBEL_SCALE),
            c.fx, c.fy, c.cx, c.cy, 0.5, 0.05)


def test_gn_step_kernel_matches_plain(dev, frames):
    """One launch (linearise, solve, gate, update) against `gn_step_reference`
    from the same T, at each level of the 160x120 pyramid."""
    T = se3.se3_exp(torch.tensor([0.004, -0.003, 0.006, 0.004, -0.006, 0.003], device=dev))
    T_before = T.clone()
    for li in range(3):
        _, pts, gray, valid, tgt, *rest = _gn_args(frames, li, T)
        T_plain, ne_plain = dops.gn_step_reference(T, pts, gray, valid, tgt, *rest)
        T_k = T.clone()
        before = _build.DENSE_NORMAL_EQ.launches
        ne_k = dops.gauss_newton(T_k, pts, gray, tgt, *rest, iters=1)
        torch.cuda.synchronize()
        assert _build.DENSE_NORMAL_EQ.launches == before + 1
        assert float(ne_k.num_inliers) == float(ne_plain.num_inliers) > 6
        for a, b in zip(ne_k[:3], ne_plain[:3]):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        assert float((T_k - T_plain).abs().max()) <= 1e-5
        assert float((T_k - T).abs().max()) > 1e-4  # the step moved T
        assert torch.equal(T, T_before)  # the plain step does not write its input


def test_gn_step_leaves_T_alone_on_an_all_invalid_source(dev, frames):
    T = se3.se3_exp(torch.tensor([0.004, -0.003, 0.006, 0.004, -0.006, 0.003], device=dev))
    _, pts, gray, _, tgt, *rest = _gn_args(frames, 0, T)
    T_k = T.clone()
    ne = dops.gauss_newton(T_k, pts * torch.tensor([1.0, 1.0, 0.0], device=dev), gray, tgt, *rest,
                           iters=3)
    assert float(ne.num_inliers) == 0.0 and float(ne.cost) == 0.0
    assert torch.equal(T_k, T)


def test_dense_tracking_on_the_card_matches_plain(dev, frames, monkeypatch):
    """The 3-level tracker, one launch per iteration, against the plain
    route (`gauss_newton_reference`) on the same CUDA tensors."""
    _, grays, depths = frames
    src = dense.preprocess_frame(grays[0], depths[0], CAM)
    tgt = dense.preprocess_frame(grays[1], depths[1], CAM)
    init = torch.eye(4, device=dev)
    before = _build.DENSE_NORMAL_EQ.launches
    res_k = dense.dense_tracking(src, tgt, CAM, init_T=init)
    assert _build.DENSE_NORMAL_EQ.launches == before + sum(dense.DEFAULT_ITERS)
    assert torch.equal(init, torch.eye(4, device=dev))  # the caller's pose is not written
    monkeypatch.setattr(dops, "gauss_newton", dops.gauss_newton_reference)
    res_p = dense.dense_tracking(src, tgt, CAM, init_T=init)
    assert _build.DENSE_NORMAL_EQ.launches == before + sum(dense.DEFAULT_ITERS)
    assert float((res_k.T_ts - res_p.T_ts).abs().max()) <= 1e-3
    assert abs(float(res_k.rmse) - float(res_p.rmse)) <= 1e-3
    assert float((res_k.T_ts - init).abs().max()) > 1e-3


def test_wrappers_reject_what_the_kernels_do_not_take(dev, frames):
    _, grays, depths = frames
    pool = tsdf_slots.make_pool(8, dev)
    keys = torch.full((4,), tsdf_ops.INVALID_KEY, dtype=torch.int32, device=dev)
    img = torch.stack([depths[0], grays[0]])
    T = torch.eye(4, device=dev)
    intr = (CAM.fx, CAM.fy, CAM.cx, CAM.cy, 0.0125, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        tsdf_slots.integrate_slots(pool, keys, keys.long(), img, T, *intr)
    with pytest.raises(ValueError, match="contiguous"):
        tsdf_slots.integrate_slots(pool, keys, keys, img, T.T, *intr)
    with pytest.raises(ValueError, match="on cpu"):
        tsdf_slots.integrate_slots(pool, keys, keys, img.cpu(), T, *intr)
    with pytest.raises(ValueError, match="shape"):
        tsdf_slots.integrate_slots(pool, keys, keys, torch.cat([img, img[1:]]), T, *intr)
    with pytest.raises(ValueError, match="dtype"):
        tsdf_slots.integrate_slots(pool, keys, keys, img.double(), T, *intr)


def test_slice_on_the_card_matches_cpu(dev, frames):
    poses, grays, depths = frames
    cam = TUM_CAMERA.pyramid(4)[3]
    kw = dict(capacity=2048, table_size=1 << 12, kmax=512, stride=2)
    g = torch.nn.functional.avg_pool2d(grays[:, None], 2)[:, 0]
    d = torch.nn.functional.avg_pool2d(depths[:, None], 2)[:, 0]
    _build.reset_launch_counts()
    on_card = FusedDenseFusion(cam, device=dev, **kw)
    on_card.process_chunk(g, d)
    est_card, _ = on_card.finalize()
    assert {k.name: k.launches for k in _build.KERNELS} == {
        "tsdf_integrate": 4, "dense_normal_eq": 3 * sum(on_card.iters), "nn1": 0}
    on_cpu = FusedDenseFusion(cam, device="cpu", **kw)
    on_cpu.process_chunk(g.cpu(), d.cpu())
    est_cpu, _ = on_cpu.finalize()
    assert np.abs(est_card - est_cpu).max() <= 1e-4
    assert abs(on_card.num_active - on_cpu.num_active) <= 0.01 * on_cpu.num_active


def test_rgb_slice_on_the_card_keeps_the_gray_geometry(dev, frames):
    """The 80x60 slice with rgbs: poses, sdf and weights bit-equal to the
    gray run's on the card (tracking reads gray only), colours finite."""
    _, grays, depths = frames
    cam = TUM_CAMERA.pyramid(4)[3]
    kw = dict(capacity=2048, table_size=1 << 12, kmax=512, stride=2)
    g = torch.nn.functional.avg_pool2d(grays[:, None], 2)[:, 0]
    d = torch.nn.functional.avg_pool2d(depths[:, None], 2)[:, 0]
    rgbs = torch.stack([_rgb(frames, i, dev) for i in range(len(g))])
    rgbs = torch.nn.functional.avg_pool2d(rgbs.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    runs = []
    for c in (None, rgbs):
        _build.reset_launch_counts()
        s = FusedDenseFusion(cam, device=dev, **kw)
        s.process_chunk(g, d, c)
        assert _build.TSDF_INTEGRATE.launches == len(g)
        runs.append((s.finalize()[0], s._state.vox[:-1]))
    (est_g, vox_g), (est_c, vox_c) = runs
    np.testing.assert_array_equal(est_c, est_g)
    assert torch.equal(vox_c[:, :2], vox_g[:, :2])
    seen = vox_c[:, 1] > 0
    col = vox_c[:, 2:5].movedim(1, -1)[seen]
    assert bool(torch.isfinite(col).all())
    assert float((col - vox_g[:, 2:5].movedim(1, -1)[seen]).abs().max()) > 0.1


def _nn1_inputs(case, dev):
    gen = torch.Generator(device="cpu").manual_seed(1)
    n, m = {"ragged": (1000, 2100), "small_ref": (777, 5), "invalid": (3000, 4500),
            "all_invalid": (300, 700), "ties": (640, 1920), "large": (32768, 32768),
            "chunk_ragged": (1500, 2500), "chunk_tie": (700, 3000), "chunk_invalid": (1200, 3000),
            "one_block": (100, 3000)}[case]
    q = torch.randn((n, 3), generator=gen)
    r = torch.randn((m, 3), generator=gen)
    v = torch.ones(m, dtype=torch.bool)
    if case == "invalid":
        v = torch.rand(m, generator=gen) > 0.2
    elif case == "all_invalid":
        v[:] = False
    elif case == "ties":  # three copies of each point: the lowest valid index wins
        r = r[:640].repeat(3, 1)
        v[:100] = False
        q = r[:640] + torch.randn((640, 3), generator=gen) * 1e-3
    elif case == "chunk_tie":  # one point at the last index of chunk 0 and the first of chunk 1
        r[1024] = r[1023]
        q[:50] = r[1023] + torch.randn((50, 3), generator=gen) * 1e-4
    elif case == "chunk_invalid":  # the whole second chunk (references 1024-2047) invalid
        v[1024:2048] = False
    return q.to(dev), r.to(dev), v.to(dev)


@pytest.mark.parametrize("case", ["ragged", "small_ref", "invalid", "all_invalid", "ties", "large",
                                  "chunk_ragged", "chunk_tie", "chunk_invalid", "one_block"])
def test_nn1_kernel_matches_plain(dev, case):
    q, r, v = _nn1_inputs(case, dev)
    before = _build.NN1.launches
    ik, dk = nn1_ops.nn1(q, r, v)
    ip, dp = nn1_ops.nn1_reference(q, r, v)
    torch.cuda.synchronize()
    assert _build.NN1.launches == before + 1
    assert ik.dtype == torch.int32 and dk.dtype == torch.float32
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    if case == "all_invalid":
        assert bool((ik == 0).all()) and bool((dk == 1e30).all())
    else:
        assert bool(v[ik.long()].all())
    if case == "ties":
        assert bool((ik[:100] >= 640).all()) and bool((ik[100:] < 640).all())
    if case == "chunk_tie":
        assert bool((ik[:50] == 1023).all())
    if case == "chunk_invalid":
        assert not bool(((ik >= 1024) & (ik < 2048)).any())


def test_nn1_rejects_what_the_kernel_does_not_take(dev):
    q, r, v = _nn1_inputs("ragged", dev)
    with pytest.raises(ValueError, match="dtype"):
        nn1_ops.nn1(q.double(), r, v)
    with pytest.raises(ValueError, match="shape"):
        nn1_ops.nn1(q[:, :2].contiguous(), r, v)
    with pytest.raises(ValueError, match="on cpu"):
        nn1_ops.nn1(q, r.cpu(), v)


def test_dense_slam_on_the_card(dev):
    """DenseSlam at 160x120, 12 frames in submaps of 4: every ICP iteration
    (and the final scoring pass) launches the nn1 kernel once; the card's
    run keeps the CPU run's decisions and poses."""
    poses = synthetic.orbit_trajectory(12)
    scene = synthetic.default_scene(dev)
    out = [synthetic.render(scene, torch.from_numpy(p).to(dev), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                            CAM.height, CAM.width, num_steps=64) for p in poses]
    depths, grays = torch.stack([d for d, _ in out]), torch.stack([g for _, g in out])
    icp_calls = []
    point_to_point = icp.point_to_point

    def counted(*args, **kwargs):
        icp_calls.append(1)
        return point_to_point(*args, **kwargs)

    icp.point_to_point = counted
    try:
        _build.reset_launch_counts()
        on_card = DenseSlam(CAM, dev, submap_size=4)
        for g, d in zip(grays, depths):
            on_card.update_frame(g, d)
    finally:
        icp.point_to_point = point_to_point
    launches = {k.name: k.launches for k in _build.KERNELS}
    assert len(icp_calls) >= 2
    assert launches == {"tsdf_integrate": 0, "dense_normal_eq": 11 * sum(dense.DEFAULT_ITERS),
                        "nn1": (icp.DEFAULT_ITERS + 1) * len(icp_calls)}
    on_cpu = DenseSlam(CAM, "cpu", submap_size=4)
    for g, d in zip(grays.cpu(), depths.cpu()):
        on_cpu.update_frame(g, d)
    flags = [[m["icp_ok"] for m in s.metrics if "icp_ok" in m] for s in (on_card, on_cpu)]
    assert flags[0] == flags[1] == [False, True, True]
    assert len(on_card.edges) == len(on_cpu.edges)
    assert np.abs(on_card.trajectory() - on_cpu.trajectory()).max() <= 1e-3
    assert traj.ate_rmse(on_card.trajectory(), poses) <= 0.01
