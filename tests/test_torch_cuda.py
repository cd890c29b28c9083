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
bit-equal (same expression, same order); marching cubes: the same
triangles in the same order, bit-equal; Hamming matching: best index,
best and second distance equal (integers); MILD feature scores within
1e-5 relative (each term bit-equal, sums in another order), candidates
equal, and two calls bit-equal; the BA Schur reduction: W and b_p within
1e-4 of the largest plain entry, S, rhs_c, V^-1 of the observed points and
the back-substitution likewise for the RGB-D model (sums in another order)
and, for the 2-D model, within 1e-2 of the plain version run in float64,
as the float32 plain version is (`_held`: the 2-D float32 system is only
as accurate as that), V^-1 of the padding points equal; two calls
bit-equal. The kernels are
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
from onepiece_tpu_torch.integration.blocks import TSDFVolume, neighbor_slots_device
from onepiece_tpu_torch.odometry import dense
from onepiece_tpu_torch.io import trajectory as traj
from onepiece_tpu_torch.io.ply import dedup_triangle_soup
from onepiece_tpu_torch.ops import dense_odometry as dops
from onepiece_tpu_torch.ops import marching_cubes as mc
from onepiece_tpu_torch.ops.mc_tables import TRI_COUNTS
from onepiece_tpu_torch.ops.mesh_dedup import dedup_triangle_soup as dedup_on_device
from onepiece_tpu_torch.lcdetection import mild
from onepiece_tpu_torch.ops import ba_schur
from onepiece_tpu_torch.ops import hamming
from onepiece_tpu_torch.ops import nn1 as nn1_ops
from onepiece_tpu_torch.ops import tsdf as tsdf_ops
from onepiece_tpu_torch.ops import tsdf_slots
from onepiece_tpu_torch.registration import icp
from onepiece_tpu_torch.systems.dense_slam import DenseSlam
from onepiece_tpu_torch.systems.fused_ba import FusedBASlam
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
from onepiece_tpu_torch.systems.fused_sparse import FusedFBASlam
from onepiece_tpu_torch.utils import synthetic, tracing

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
        "tsdf_integrate": 4, "dense_normal_eq": 3 * sum(on_card.iters), "nn1": 0, "marching_cubes": 0,
        "hamming": 0, "ba_schur": 0}
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


@pytest.fixture(scope="module")
def slam_frames(dev):
    """The 12-frame 160x120 orbit: (poses, grays, depths)."""
    poses = synthetic.orbit_trajectory(12)
    scene = synthetic.default_scene(dev)
    out = [synthetic.render(scene, torch.from_numpy(p).to(dev), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                            CAM.height, CAM.width, num_steps=64) for p in poses]
    return poses, torch.stack([g for _, g in out]), torch.stack([d for d, _ in out])


def _dense_slam(dev, grays, depths):
    slam = DenseSlam(CAM, dev, submap_size=4)
    for g, d in zip(grays, depths):
        slam.update_frame(g, d)
    return slam


def test_dense_slam_on_the_card(dev, slam_frames):
    """DenseSlam at 160x120, 12 frames in submaps of 4: every ICP iteration
    (and the final scoring pass) launches the nn1 kernel once; the card's
    run keeps the CPU run's decisions and poses."""
    poses, grays, depths = slam_frames
    icp_calls = []
    point_to_point = icp.point_to_point

    def counted(*args, **kwargs):
        icp_calls.append(1)
        return point_to_point(*args, **kwargs)

    icp.point_to_point = counted
    try:
        _build.reset_launch_counts()
        on_card = _dense_slam(dev, grays, depths)
    finally:
        icp.point_to_point = point_to_point
    launches = {k.name: k.launches for k in _build.KERNELS}
    assert len(icp_calls) >= 2
    assert launches == {"tsdf_integrate": 0, "dense_normal_eq": 11 * sum(dense.DEFAULT_ITERS),
                        "nn1": (icp.DEFAULT_ITERS + 1) * len(icp_calls), "marching_cubes": 0, "hamming": 0,
                        "ba_schur": 0}
    on_cpu = _dense_slam("cpu", grays.cpu(), depths.cpu())
    flags = [[m["icp_ok"] for m in s.metrics if "icp_ok" in m] for s in (on_card, on_cpu)]
    assert flags[0] == flags[1] == [False, True, True]
    assert len(on_card.edges) == len(on_cpu.edges)
    assert np.abs(on_card.trajectory() - on_cpu.trajectory()).max() <= 1e-3
    assert traj.ate_rmse(on_card.trajectory(), poses) <= 0.01


def test_dense_slam_on_the_card_repeats_bit_for_bit(dev, slam_frames):
    """Two DenseSlam runs on the same frames give the same trajectory, edges
    and submap clouds to the last bit: nothing on the path sums in an order
    that changes from run to run (`voxel_downsample` sums in point order)."""
    _, grays, depths = slam_frames
    a, b = (_dense_slam(dev, grays, depths) for _ in range(2))
    assert np.array_equal(a.trajectory(), b.trajectory())
    assert [(e["src"], e["dst"]) for e in a.edges] == [(e["src"], e["dst"]) for e in b.edges]
    assert len(a.submap_clouds) == len(b.submap_clouds) == 3
    for ca, cb in zip(a.submap_clouds, b.submap_clouds):
        for field in ("points", "normals", "colors", "valid"):
            assert torch.equal(getattr(ca, field), getattr(cb, field))


def _mc_pool(dev, sdf, weight, seed=0):
    """A pool of len(sdf) blocks (+ trash row) with the given (P, 512) sdf and
    weights and seeded uniform colour."""
    p = sdf.shape[0]
    pool = tsdf_slots.make_pool(p, dev)
    pool[:p, 0] = torch.as_tensor(sdf, dtype=torch.float32, device=dev)
    pool[:p, 1] = torch.as_tensor(weight, dtype=torch.float32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    pool[:p, 2:5] = torch.rand((p, 3, 512), generator=gen).to(dev)
    return pool


def _grid(n):
    """Block coords of an n x n x n grid and each block's 7 neighbour slots."""
    coords = np.array([[x, y, z] for x in range(n) for y in range(n) for z in range(n)])
    slot_of = {tuple(c): i for i, c in enumerate(coords.tolist())}
    nbr = np.array([[slot_of.get(tuple(c + o), -1) for o in mc.NEIGHBOR_OFFSETS.tolist()] for c in coords.tolist()])
    return coords, nbr


def _mc_kernel_vs_plain(pool, slots, nbr, coords, voxel=0.05, launched=1):
    dev = pool.device
    args = (pool, torch.as_tensor(slots, dtype=torch.int32, device=dev),
            torch.as_tensor(nbr, dtype=torch.int32, device=dev),
            torch.as_tensor(coords, dtype=torch.int32, device=dev), voxel)
    before = _build.MARCHING_CUBES.launches
    vk, ck = mc.extract_triangles(*args)
    vp, cp = mc.extract_triangles_reference(*args)
    torch.cuda.synchronize()
    assert _build.MARCHING_CUBES.launches == before + launched
    assert vk.shape == vp.shape and ck.shape == cp.shape
    assert torch.equal(vk, vp) and torch.equal(ck, cp)
    return vk


def _configs(sdf_grid, w_grid):
    """Marching-cubes cases of the meshable voxels of a (X, Y, Z) corner grid."""
    n = np.array(sdf_grid.shape) - 1
    cfg = np.zeros(tuple(n), np.int64)
    ok = np.ones(tuple(n), bool)
    for c in range(8):
        dx, dy, dz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        s = sdf_grid[dx:dx + n[0], dy:dy + n[1], dz:dz + n[2]]
        ok &= (w_grid[dx:dx + n[0], dy:dy + n[1], dz:dz + n[2]] > 0) & (np.abs(s) < 1.5)
        cfg |= (s < 0).astype(np.int64) << c
    return cfg[ok]


def test_mc_kernel_all_256_cases(dev):
    """4x4x4 blocks of random-sign sdf (|sdf| in [0.05, 1]): every one of the
    256 cases occurs, and the kernel equals the plain version."""
    rng = np.random.default_rng(0)
    coords, nbr = _grid(4)
    sdf = rng.uniform(0.05, 1.0, (64, 512)) * rng.choice([-1.0, 1.0], (64, 512))
    pool = _mc_pool(dev, sdf, np.ones((64, 512)))
    full = np.zeros((33, 33, 33))  # the grid's corner field; the far faces have no neighbour
    for (x, y, z), s in zip(coords.tolist(), sdf.reshape(64, 8, 8, 8)):
        full[8 * x:8 * x + 8, 8 * y:8 * y + 8, 8 * z:8 * z + 8] = s
    w = np.zeros((33, 33, 33))
    w[:32, :32, :32] = 1.0
    assert len(np.unique(_configs(full, w))) == 256
    vk = _mc_kernel_vs_plain(pool, np.arange(64), nbr, coords)
    assert vk.shape[0] > 50000


def test_mc_kernel_every_halo_region_absent_or_present(dev):
    """One block copied 128 times, each copy with another subset of its 7
    neighbours (faces, edges, corner) absent."""
    rng = np.random.default_rng(1)
    sdf = rng.uniform(-1.2, 1.2, (8, 512))
    weight = rng.integers(1, 3, (8, 512)).astype(np.float64)
    pool = _mc_pool(dev, sdf, weight)
    masks = np.array([[(m >> j) & 1 for j in range(7)] for m in range(128)], bool)
    nbr = np.where(masks, np.arange(1, 8)[None], -1)
    coords = rng.integers(-40, 40, (128, 3))
    vk = _mc_kernel_vs_plain(pool, np.zeros(128, np.int64), nbr, coords)
    assert vk.shape[0] > 128 * 200


def test_mc_kernel_zero_weights_one_block_and_empty(dev):
    rng = np.random.default_rng(2)
    sdf = rng.uniform(-1.0, 1.0, (27, 512))
    weight = rng.integers(0, 2, (27, 512)).astype(np.float64)  # half the corners unobserved
    coords, nbr = _grid(3)
    pool = _mc_pool(dev, sdf, weight)
    some = _mc_kernel_vs_plain(pool, np.arange(27), nbr, coords)
    assert some.shape[0] > 0
    one = _mc_kernel_vs_plain(pool, [13], nbr[13:14], coords[13:14])  # one block, with neighbours
    assert 0 < one.shape[0] < some.shape[0]
    empty = _mc_pool(dev, np.full((27, 512), tsdf_ops.EMPTY_SDF), np.zeros((27, 512)))
    assert _mc_kernel_vs_plain(empty, np.arange(27), nbr, coords).shape == (0, 3, 3)  # T = 0
    none = _mc_kernel_vs_plain(pool, np.zeros(0), np.zeros((0, 7)), np.zeros((0, 3)), launched=0)  # B = 0
    assert none.shape == (0, 3, 3)


def test_mc_kernel_rejects_what_it_does_not_take(dev):
    pool = tsdf_slots.make_pool(4, dev)
    slots = torch.zeros(2, dtype=torch.int32, device=dev)
    nbr = torch.full((2, 7), -1, dtype=torch.int32, device=dev)
    coords = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        mc.extract_triangles(pool, slots.long(), nbr, coords, 0.05)
    with pytest.raises(ValueError, match="shape"):
        mc.extract_triangles(pool, slots, nbr[:, :6].contiguous(), coords, 0.05)
    with pytest.raises(ValueError, match="on cpu"):
        mc.extract_triangles(pool, slots, nbr, coords.cpu(), 0.05)


def _sphere_volume(dev):
    """The analytic sphere (r 0.5 at the origin) over 4x4x4 blocks of 0.05 m
    voxels, weight 1 everywhere: a closed surface inside the blocks."""
    vol = TSDFVolume(voxel_size=0.05, truncation=10.0, capacity=256, device=dev)
    vol.allocate(np.array([[x, y, z] for x in range(-2, 2) for y in range(-2, 2) for z in range(-2, 2)]))
    n = vol.num_active
    centers = tsdf_ops.voxel_centers_world(torch.from_numpy(vol.active_coords()).to(dev), vol.voxel_size)
    vol.vox[:n, 0] = torch.clamp((torch.linalg.norm(centers, dim=-1) - 0.5) / vol.truncation, -1, 1)
    vol.vox[:n, 1] = 1.0
    return vol


def test_mc_kernel_sphere_is_watertight(dev):
    vol = _sphere_volume(dev)
    before = _build.MARCHING_CUBES.launches
    tv, tc = vol.extract_mesh()
    assert _build.MARCHING_CUBES.launches == before + 1
    verts, faces, _ = dedup_triangle_soup(tv, tc)
    assert len(faces) > 100 and np.abs(np.linalg.norm(verts, axis=-1) - 0.5).max() < 0.06
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    uniq, counts = np.unique(np.sort(edges, axis=1), axis=0, return_counts=True)
    assert (counts == 2).all()
    assert (np.unique(edges, axis=0, return_counts=True)[1] == 1).all()  # consistent winding
    assert len(verts) - len(uniq) + len(faces) == 2  # Euler characteristic of a sphere
    # the neighbour slots found on the card are the host dict's
    nbr = neighbor_slots_device(torch.from_numpy(vol.active_coords()).to(dev))
    np.testing.assert_array_equal(nbr.cpu().numpy(), vol._neighbor_slots())


def test_volume_integrate_and_mesh_on_the_card_matches_cpu(dev, frames):
    """TSDFVolume.integrate (TSDF kernel) then extract_mesh (marching-cubes
    kernel) on the card against the same run with device="cpu"; and the
    card's pool meshed by the plain version equals the kernel's mesh."""
    poses, grays, depths = frames
    vols = {}
    _build.reset_launch_counts()
    for d in (dev, "cpu"):
        vol = TSDFVolume(voxel_size=0.02, truncation=0.1, capacity=1024, device=d)
        for i in range(3):
            vol.integrate(depths[i].to(d), grays[i].to(d)[..., None].expand(-1, -1, 3), poses[i], CAM)
        vols[d if d == "cpu" else "cuda"] = (vol, vol.extract_mesh())
    assert _build.TSDF_INTEGRATE.launches == 3 and _build.MARCHING_CUBES.launches == 1
    (vk, (tvk, _)), (vc, (tvc, _)) = vols["cuda"], vols["cpu"]
    assert abs(vk.num_active - vc.num_active) <= 0.01 * vc.num_active
    assert abs(len(tvk) - len(tvc)) <= 0.02 * len(tvc) and len(tvk) > 5000
    na = vk.num_active
    coords = torch.from_numpy(vk.active_coords()).int()
    vp, cp = mc.extract_triangles_reference(vk.vox.cpu(), torch.arange(na, dtype=torch.int32),
                                            neighbor_slots_device(coords), coords, vk.voxel_size)
    np.testing.assert_array_equal(tvk, vp.numpy())
    np.testing.assert_array_equal(vols["cuda"][1][1], cp.numpy())


def test_mc_kernel_dense_block_spans_every_step(dev):
    """One block of checkerboard sdf (4 triangles in every meshable voxel,
    1,372 in all): each of the warp's 16 voxel steps stages and writes its
    own range of rows."""
    ijk = np.indices((8, 8, 8)).reshape(3, -1).T
    sdf = np.where(ijk.sum(1) % 2 == 0, 0.5, -0.5)[None]
    pool = _mc_pool(dev, sdf, np.ones((1, 512)))
    vk = _mc_kernel_vs_plain(pool, [0], np.full((1, 7), -1), [[2, -3, 5]])
    assert vk.shape[0] == 7**3 * 4


def _one_voxel_block(config):
    """(sdf, weight) (512,) of a block whose only meshable voxel is (0, 0, 0),
    its corner signs the marching-cubes case `config`."""
    sdf, weight = np.full((8, 8, 8), 0.5), np.zeros((8, 8, 8))
    for c in range(8):
        dx, dy, dz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        sdf[dx, dy, dz] = -0.5 if (config >> c) & 1 else 0.5
        weight[dx, dy, dz] = 1.0
    return sdf.reshape(-1), weight.reshape(-1)


def test_mc_kernel_ranges_start_at_every_alignment(dev):
    """Blocks of 1, 2 and 3 triangles before dense blocks: the dense blocks'
    first rows (36 B each) start at every offset modulo 16 B."""
    cases = {n: int(np.flatnonzero(TRI_COUNTS == n)[0]) for n in (1, 2, 3)}
    small = [_one_voxel_block(cases[n]) for n in (1, 2, 3)]
    dense = np.where(np.indices((8, 8, 8)).reshape(3, -1).sum(0) % 2 == 0, 0.5, -0.5)
    sdf = np.stack([s for s, _ in small] + [dense])
    weight = np.stack([w for _, w in small] + [np.ones(512)])
    pool = _mc_pool(dev, sdf, weight)
    slots = [0, 3, 1, 3, 2, 3, 2, 2, 3]  # rows start at 0, 1, 1373, 1375, 2747, 2750, 4122, 4125, 4128
    rng = np.random.default_rng(3)
    coords = rng.integers(-40, 40, (len(slots), 3))
    vk = _mc_kernel_vs_plain(pool, slots, np.full((len(slots), 7), -1), coords)
    counts = np.array([1, 2, 3, 1372])[slots]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    assert vk.shape[0] == counts.sum()
    assert set((starts[np.array(slots) == 3] * 9) % 4) == {0, 1, 2, 3}


def test_mc_kernel_twenty_thousand_blocks(dev):
    """20,000 blocks over 64 rows of random sdf, random neighbour rows (some
    absent, some outside the pool)."""
    rng = np.random.default_rng(4)
    sdf = rng.uniform(-1.2, 1.2, (64, 512))
    weight = rng.integers(0, 3, (64, 512)).astype(np.float64)
    pool = _mc_pool(dev, sdf, weight)
    n = 20000
    slots = rng.integers(-2, 66, n)
    nbr = rng.integers(-1, 66, (n, 7))
    vk = _mc_kernel_vs_plain(pool, slots, nbr, rng.integers(-400, 400, (n, 3)))
    assert vk.shape[0] > n * 50


def test_device_dedup_equals_numpy_on_a_fused_soup(dev, frames):
    """The fused loop's volume at 160x120, meshed by the kernel: the dedup on
    the card gives numpy's vertices, faces and colours, bit for bit."""
    _, grays, depths = frames
    slam = FusedDenseFusion(CAM, device=dev, kmax=4096, stride=2)
    slam.process_chunk(grays, depths)
    tv, tc = slam.to_volume().extract_mesh_tensors()
    assert tv.is_cuda and tv.shape[0] > 5000
    mine = dedup_on_device(tv, tc)
    ref = dedup_triangle_soup(tv.cpu().numpy(), tc.cpu().numpy())
    for a, b in zip(mine, ref):
        assert a.is_cuda
        np.testing.assert_array_equal(a.cpu().numpy(), b)


def _random_words(rng, shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape + (8,), dtype=np.uint64).astype(np.uint32).view(np.int32)


# (queries, targets, what is special): the targets are listed 1,024 at a
# time, 4 queries a CTA, a warp a query
_MATCH_CASES = {
    "random_1x2": (1, 2, None), "random_63x65": (63, 65, None), "random_1000x1000": (1000, 1000, None),
    "random_700x1300": (700, 1300, None),
    "all_invalid": (100, 300, "all_invalid"), "one_valid": (100, 300, "one_valid"),
    "all_ties": (64, 500, "all_ties"), "empty_window": (200, 300, "empty_window"),
    "ragged_n": (1003, 257, None), "m2": (50, 2, None), "below_a_tile": (130, 100, None),
    "several_tiles": (130, 3000, None), "all_valid_1000x1000": (1000, 1000, "all_valid"),
}


@pytest.mark.parametrize("case", list(_MATCH_CASES))
def test_hamming_match_kernel_vs_plain(dev, case):
    """Best index (int64), best and second distance equal, unwindowed, in a
    20 px window and in a 1000 px one, with duplicated targets (ties) and
    invalid targets, at the edges of the lane merge (no valid target, one,
    all tied, empty windows), of the grid (N not a multiple of the CTA's 4
    queries) and of the target tiles (M = 2, below one tile, across three);
    the whole table equal too."""
    n, m, special = _MATCH_CASES[case]
    rng = np.random.default_rng(n + m)
    b = _random_words(rng, (m,))
    b[1::3] = b[0:-1:3]
    a = b[rng.integers(0, m, n)] ^ (rng.random((n, 8)) < 0.05).astype(np.int32)
    vb = rng.random(m) > 0.2
    uva = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    uvb = rng.uniform(0, 640, (m, 2)).astype(np.float32)
    if special == "all_invalid":
        vb[:] = False
    elif special == "one_valid":
        vb[:] = False
        vb[m // 2] = True
        uva[: n // 2] = uvb[m // 2] + 5.0
    elif special == "all_ties":
        b[:] = b[0]
        a[: n // 2] = b[0]
        uvb[:] = 320.0
        uva[: n // 2] = 330.0
    elif special == "empty_window":
        uvb += 2000.0
    elif special == "all_valid":
        vb[:] = True
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    vb = t(vb)
    for args in ((t(a), t(b), vb), (t(a), t(b), vb, t(uva), t(uvb), 20.0), (t(a), t(b), vb, t(uva), t(uvb), 1000.0)):
        _build.reset_launch_counts()
        k = hamming.hamming_match(*args)
        p = hamming.hamming_match_reference(*args)
        torch.cuda.synchronize()
        assert _build.HAMMING.launches == 1 and k[0].dtype == torch.int64
        for x, y in zip(k, p):
            assert torch.equal(x, y)
        if special in ("all_invalid", "empty_window") and len(args) > 3:
            assert bool((k[0] == 0).all() & (k[1] == 257).all() & (k[2] == 257).all())
        if special == "one_valid":
            assert bool((k[2] == 257).all())
    assert torch.equal(hamming.hamming_table(t(a), t(b)), hamming.hamming_table_reference(t(a), t(b)))


@pytest.mark.parametrize("case", ["g39", "g0", "g_cap", "empty_keyframe", "no_valid_query", "two_tiles"])
def test_mild_feature_scores_kernel_vs_plain(dev, case):
    """fs within 1e-5 relative at 1000 queries x 128 keyframes x 1000
    features, g = 39 (rows past g written 0 on the device), g = 0, g = 128,
    a keyframe with no valid feature and no valid query; and at 1300
    queries x 8 keyframes x 2100 features, g = 5, where the kernel lists
    queries and features 1,024 at a time (a second query tile ranked after
    the first's valid queries; each sum carried from one feature tile to
    the next), with near features in both tiles; candidates equal; two
    calls bit-equal (each sum in one fixed order, no atomics)."""
    rng = np.random.default_rng(7)
    n, n_cap, f = (1300, 8, 2100) if case == "two_tiles" else (1000, 128, 1000)
    q = _random_words(rng, (n,))
    db = _random_words(rng, (n_cap, f))
    db[:, :400] = q[None, :400] ^ (rng.random((n_cap, 400, 8)) < 0.04).astype(np.int32)
    if case == "two_tiles":  # the second query tile near the second feature tile
        db[:, 1600:2000] = q[None, 900:1300] ^ (rng.random((n_cap, 400, 8)) < 0.04).astype(np.int32)
    qv, dbv = rng.random(n) > 0.1, rng.random((n_cap, f)) > 0.2
    gi = {"g0": 0, "g_cap": 128, "two_tiles": 5}.get(case, 39)
    if case == "empty_keyframe":
        dbv[11] = False
    if case == "no_valid_query":
        qv[:] = False
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    qv, dbv = t(qv), t(dbv)
    g = torch.tensor(gi, device=dev)
    _build.reset_launch_counts()
    fk = mild.mild_feature_scores(t(q), qv, t(db), dbv, g)
    assert _build.HAMMING.launches == 1
    fp = mild.mild_feature_scores_reference(t(q), qv, t(db), dbv, g)
    assert torch.equal(mild.mild_feature_scores(t(q), qv, t(db), dbv, g), fk)
    assert bool((fk[:, gi:] == 0).all()) and bool((fk[~qv] == 0).all())
    if case in ("g0", "no_valid_query"):
        assert not bool(fk.any()) and not bool(fp.any())
    else:
        assert float(fp.max()) > 0
    if case == "two_tiles":  # both tiles' near features reach their queries
        assert bool((fp[900:1300, :gi] > 0.5).any()) and bool((fp[:400, :gi] > 0.5).any())
    if case == "empty_keyframe":
        assert not bool(fk[:, 11].any())
    assert float((fk - fp).abs().max()) <= 1e-5 * float(fp.abs().max())
    rest = (g, g - 1, torch.tensor(-1, device=dev))
    ck, ok_k = mild.lc_candidates_device(t(q), qv, t(db), dbv, *rest)
    cp, ok_p = mild.candidates_from_scores(fp, qv, *rest)
    assert torch.equal(ck, cp) and torch.equal(ok_k, ok_p)


def test_hamming_wrappers_reject_unaligned_descriptors(dev):
    """The kernels read descriptors as 16-byte vectors: a view that does not
    start on 16 bytes is refused, not read across."""
    words = torch.zeros(65 * 8 + 1, dtype=torch.int32, device=dev)
    a, bad = words[:64 * 8].view(64, 8), words[1:].view(65, 8)
    vb = torch.ones(65, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        hamming.hamming_match(a, bad, vb)
    with pytest.raises(ValueError, match="aligned"):
        hamming.hamming_table(bad, a)
    with pytest.raises(ValueError, match="aligned"):
        mild.mild_feature_scores(bad[:64], vb[:64], a.view(8, 8, 8), vb[:64].view(8, 8), 8)


def test_fused_sparse_on_the_card(dev, frames):
    """FusedFBASlam at 160x120 on the card: the Hamming kernel is launched,
    the trajectory is finite and close to the ground truth."""
    poses, grays, depths = frames
    _build.reset_launch_counts()
    slam = FusedFBASlam(CAM, device=dev, max_keypoints=500, keyframe_disparity=10.0)
    slam.process_chunk(grays, depths)
    assert _build.HAMMING.launches >= 2 * (len(grays) - 1)
    est = slam.trajectory()
    assert np.isfinite(est).all() and slam.edge_overflow == 0
    assert traj.ate_rmse(est, poses) < 0.05


def _ba_problem(case: str, model: str, dev):
    """A capacity-padded BA problem: F frames (pose 0 and the padding
    inactive), P points of which the first `n_pts` are observed, O rows of
    which the first are valid. `case` adds what it names."""
    rng = np.random.default_rng(len(case) * 2 + (model == "2d"))
    F, P, O, n_kf, n_pts, n_obs = {"orbit": (64, 1024, 4096, 8, 230, 604),
                                   "loop": (128, 2048, 8192, 39, 1241, 4000),
                                   "max_frames": (1613, 64, 512, 40, 60, 300),
                                   "f2048_few_live": (2048, 64, 512, 8, 60, 300)}.get(
                                       case, (16, 256, 1024, 10, 150, 600))
    ang = rng.normal(size=(F, 3)) * 0.1
    xi = np.concatenate([rng.normal(size=(F, 3)) * 0.2, ang], 1).astype(np.float32)
    poses = se3.se3_exp(torch.from_numpy(xi)).numpy()
    pts = np.concatenate([rng.uniform(-1, 1, (P, 2)), rng.uniform(1.5, 3.5, (P, 1))], 1).astype(np.float32)
    frame = rng.integers(0, n_kf, O)
    point = rng.integers(0, n_pts, O)
    if case == "one_observation":  # point n_pts - 1 seen once
        point[:n_obs][point[:n_obs] == n_pts - 1] = 0
        point[5] = n_pts - 1
    if case == "frame_without_observations":
        frame[:n_obs][frame[:n_obs] == 3] = 4
    if case == "two_in_one_frame":  # every other observation repeats the one before, with another measurement
        frame[1:n_obs:2], point[1:n_obs:2] = frame[0:n_obs - 1:2], point[0:n_obs - 1:2]
    if case == "f2048_few_live":  # the live frames spread over the capacity, the last one among them
        frame = np.linspace(0, F - 1, n_kf).astype(np.int64)[frame]
    pc = np.einsum("oij,oj->oi", poses[frame, :3, :3], pts[point]) + poses[frame, :3, 3]
    pc_obs = (pc + rng.normal(size=pc.shape) * 0.003).astype(np.float32)
    uv = np.stack([pc[:, 0] / pc[:, 2] * 260 + 80, pc[:, 1] / pc[:, 2] * 260 + 60], -1)
    uv = (uv + rng.normal(size=uv.shape)).astype(np.float32)
    valid = np.arange(O) < n_obs
    pts_noisy = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.01
    pts_noisy[n_pts:] = 0
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    args = (t(poses), t(pts_noisy), t(frame), t(point), t(uv), t(valid), torch.tensor(3e-5, device=dev),
            (260.0, 260.0, 80.0, 60.0), t(pc_obs) if model == "3d" else None)
    return args, n_pts


_BA_CASES = ["orbit", "loop", "one_observation", "padding_points", "frame_without_observations",
             "two_in_one_frame", "max_frames", "f2048_few_live"]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) / max(float(b.abs().max()), 1e-30)


def _held(kernel, plain, plain_cpu, exact, what: str, model: str) -> None:
    """The RGB-D model: kernel within 1e-4 of the plain version's largest
    entry. The 2-D model: at the first LM step's damping its float32 system
    is set by rounding. Weakly triangulated points give damped blocks V of
    condition ~1e4-1e5, which amplify the rounding of the Jacobian
    products. The kernel rounds them as the plain version does on the CPU
    (a multiply, then an add); on the card the plain version's einsums fuse
    the two and round otherwise. Against float64 on these cases (an H100):
    the kernel and the CPU plain version agree to 3 digits on V^-1 and dp
    and within 1.3x on S and rhs_c, and the card's plain version lies
    within 0.3x-3x of them. So the 2-D kernel's error against the plain
    version run in float64 is held to 2x the larger of the two float32
    plain versions' errors. `test_ba_schur_kernel_damps_as_plain` holds
    both models within 1e-4 at larger dampings."""
    if model == "3d":
        assert _rel(kernel, plain) <= 1e-4, what
    else:
        ek, ep = _rel(kernel, exact), max(_rel(plain, exact), _rel(plain_cpu, exact))
        assert ek <= 2 * ep, (what, ek, ep)


@pytest.mark.parametrize("model", ["3d", "2d"])
@pytest.mark.parametrize("case", _BA_CASES)
def test_ba_schur_kernel_vs_plain(dev, case, model):
    """The reduced system and the back-substitution against the plain
    versions (JAX's dense form; see `_held`), one launch a wrapper call, two
    calls bit-equal; at the orbit's and the loop's capacities, with a point
    seen once, padding points, a frame with no observation, two
    observations of one point in one frame, at F = 1,613, and at F = 2,048
    with 8 live frames spread over the capacity."""
    args, n_pts = _ba_problem(case, model, dev)
    poses, points, frame, point, uv, valid, lam, intr, pc = args
    lists = ba_schur.build_lists(frame, point, valid, poses.shape[0], points.shape[0])
    _build.reset_launch_counts()
    k = ba_schur.reduced_system(*args, lists=lists)
    assert _build.BA_SCHUR.launches == 1
    k2 = ba_schur.reduced_system(*args, lists=lists)
    p = ba_schur.reduced_system_reference(*args)
    x, c = p, p
    if model == "2d":  # the plain version in float64, and in float32 on the CPU
        x = ba_schur.reduced_system_reference(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                                                for a in args))
        c = ba_schur.reduced_system_reference(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    torch.cuda.synchronize()
    for name in ("S", "rhs_c", "Vinv", "b_p"):
        assert torch.equal(getattr(k, name), getattr(k2, name)), name
    # the linearisation: W of the listed observations and b_p, within 1e-4
    assert _rel(k.W[valid], p.W[valid]) <= 1e-4 and _rel(k.b_p, p.b_p) <= 1e-4
    for name in ("S", "rhs_c"):
        _held(getattr(k, name), getattr(p, name), getattr(c, name).to(dev), getattr(x, name), name, model)
    obs = torch.zeros(points.shape[0], dtype=torch.bool, device=dev)
    obs[point[valid]] = True
    pad = 1e9 * torch.eye(3, device=dev)  # a point with no observation damps to 1e-9 I
    assert torch.equal(k.Vinv[~obs], p.Vinv[~obs]) and float((p.Vinv[~obs] - pad).abs().max()) <= 1e3
    _held(k.Vinv[obs], p.Vinv[obs], c.Vinv.to(dev)[obs], x.Vinv[obs], "Vinv", model)
    if case == "frame_without_observations":  # its diagonal block is the damping floor, its row elsewhere 0
        blk = k.S[18:24]
        assert bool((blk[:, 18:24] == 1e-9 * torch.eye(6, device=dev)).all()) and float(blk[:, :18].abs().max()) == 0
    dc = torch.from_numpy(np.random.default_rng(1).normal(size=6 * poses.shape[0]).astype(np.float32) * 1e-3).to(dev)
    _build.reset_launch_counts()
    dk = ba_schur.back_substitute(k, dc, frame, point, lists)
    assert _build.BA_SCHUR.launches == 1
    dp = ba_schur.back_substitute_reference(p, dc, frame, point)
    dx = ba_schur.back_substitute_reference(x, dc.to(x.S.dtype), frame, point)
    dcpu = ba_schur.back_substitute_reference(c, dc.to(c.S.device), frame.to(c.S.device), point.to(c.S.device))
    torch.cuda.synchronize()
    assert torch.equal(dk, ba_schur.back_substitute(k2, dc, frame, point, lists))
    _held(dk[:n_pts], dp[:n_pts], dcpu.to(dev)[:n_pts], dx[:n_pts], "dp", model)
    assert float(dk[n_pts:].abs().max()) == 0


# dampings the LM loop reaches after rejections (x2 each from 3e-5): the most
# FusedBASlam's 8 steps reach, and one within the host loop's 20
BA_DAMPINGS = (3e-5 * 2**8, 1.0)


@pytest.mark.parametrize("lam", BA_DAMPINGS)
@pytest.mark.parametrize("model", ["3d", "2d"])
@pytest.mark.parametrize("case", _BA_CASES)
def test_ba_schur_kernel_damps_as_plain(dev, case, model, lam):
    """At the dampings LM reaches after rejections, both models' kernel
    systems within 1e-4 of the plain version's largest entry (the damping
    makes the 2-D blocks well conditioned: measured within 2e-5), while
    the damping moves the plain S, V^-1 and dp by more than 1e-3 (measured:
    7.6e-3 and more), so a kernel that dropped or misplaced lam fails."""
    args, n_pts = _ba_problem(case, model, dev)
    frame, point, valid = args[2], args[3], args[5]
    lists = ba_schur.build_lists(frame, point, valid, args[0].shape[0], args[1].shape[0])
    obs = lists.point_ptr.diff() > 0

    def at(damping):
        return (*args[:6], torch.tensor(damping, device=dev), *args[7:])

    k = ba_schur.reduced_system(*at(lam), lists=lists)
    p = ba_schur.reduced_system_reference(*at(lam))
    p0 = ba_schur.reduced_system_reference(*at(0.0))
    dc = torch.from_numpy(np.random.default_rng(1).normal(size=k.rhs_c.shape[0]).astype(np.float32) * 1e-3).to(dev)
    dk = ba_schur.back_substitute(k, dc, frame, point, lists)
    dp, dp0 = (ba_schur.back_substitute_reference(s, dc, frame, point) for s in (p, p0))
    for name, a, b, b0 in (("S", k.S, p.S, p0.S), ("rhs_c", k.rhs_c, p.rhs_c, p0.rhs_c),
                           ("Vinv", k.Vinv[obs], p.Vinv[obs], p0.Vinv[obs]),
                           ("dp", dk[:n_pts], dp[:n_pts], dp0[:n_pts])):
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))
        assert name == "rhs_c" or _rel(b, b0) > 1e-3, (name, _rel(b, b0))


def test_ba_schur_rejects_what_the_kernel_does_not_take(dev):
    args, _ = _ba_problem("small", "3d", dev)
    poses, points, frame, point, uv, valid, lam, intr, pc = args
    lists = ba_schur.build_lists(frame, point, valid, poses.shape[0], points.shape[0])
    with pytest.raises(ValueError, match="lists"):
        ba_schur.reduced_system(*args)
    with pytest.raises(ValueError, match="frames"):
        none = torch.empty((0, 4, 4), device=dev)
        ba_schur.reduced_system(none, points, frame, point, uv, valid, lam, intr, pc, lists)
    with pytest.raises(ValueError, match="dtype"):
        ba_schur.reduced_system(poses.double(), points, frame, point, uv, valid, lam, intr, pc, lists)
    with pytest.raises(ValueError, match="dtype"):
        ba_schur.reduced_system(poses, points, frame.int(), point, uv, valid, lam, intr, pc, lists)
    with pytest.raises(ValueError, match="contiguous"):
        ba_schur.reduced_system(poses, points.T.contiguous().T, frame, point, uv, valid, lam, intr, pc, lists)
    with pytest.raises(ValueError, match="shape"):
        ba_schur.reduced_system(poses, points, frame, point, uv, valid, lam.reshape(1), intr, pc, lists)
    k = ba_schur.reduced_system(*args, lists=lists)
    dc = torch.zeros(6 * poses.shape[0], device=dev)
    with pytest.raises(ValueError, match="lists"):
        ba_schur.back_substitute(k, dc, frame, point)
    plain = ba_schur.reduced_system_reference(*args)
    with pytest.raises(ValueError, match="per-observation"):
        ba_schur.back_substitute(plain, dc, frame, point, lists)


READS = ("sync.ladder", "sync.promotions", "sync.lc_pairs", "sync.chunk_fetch")


def _ba_run(dev, grays, depths):
    """One chunk of FusedBASlam, and the host reads its `sync.*` counters
    count (on while a profiler records)."""
    slam = FusedBASlam(CAM, device=dev, max_keypoints=500, keyframe_disparity=10.0, ba_iters=6)
    before = tracing.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        slam.process_chunk(grays, depths)
    after = tracing.counters()
    return slam, [after.get(k, 0) - before.get(k, 0) for k in READS]


def test_fused_ba_on_the_card(dev, frames):
    """FusedBASlam at 160x120 on the card: the BA kernel runs 2 launches an
    LM iteration, no other kernel but Hamming; the trajectory in the CPU
    run's regime (the two devices draw different random numbers); two card
    runs bit-equal, track state included."""
    poses, grays, depths = frames
    _build.reset_launch_counts()
    a, a_reads = _ba_run(dev, grays, depths)
    launches = {k.name: k.launches for k in _build.KERNELS}
    assert launches["ba_schur"] == 2 * 6 and launches["hamming"] >= 2 * (len(grays) - 1)
    assert sum(launches.values()) == launches["ba_schur"] + launches["hamming"]
    b, _ = _ba_run(dev, grays, depths)
    cpu, cpu_reads = _ba_run("cpu", grays.cpu(), depths.cpu())
    est = a.trajectory()
    assert np.isfinite(est).all() and a.pt_overflow == 0 and a.obs_overflow == 0 and a.n_pts > 0
    ate, ate_cpu = traj.ate_rmse(est, poses), traj.ate_rmse(cpu.trajectory(), poses)
    assert ate < 0.05 and ate < max(3 * ate_cpu, 0.05) and abs(a.num_kf - cpu.num_kf) <= 2, (ate, ate_cpu)
    assert a.ba_mse < 1e-3 and a_reads == cpu_reads and a_reads[0] == len(grays)
    assert np.array_equal(est, b.trajectory()) and a.ba_mse == b.ba_mse
    for x, y in zip(a._track_state, b._track_state):
        assert torch.equal(x, y)


def test_ring_upload_path_on_the_card(dev, tmp_path):
    """A 12-frame 160x120 folder through the CLIs' path on the card: the
    prefetch ring (`_torch_common.load_frames`), chunks of 8 uploaded through
    pinned memory (`chunks`): the tensors on the card equal the eager decode,
    FusedDenseFusion over them makes no host sync, and no worker is left."""
    import argparse
    import sys
    from pathlib import Path

    from onepiece_tpu_torch.io import tum
    from onepiece_tpu_torch.io.tum_frames import read_frames, to_floats

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    from _torch_common import chunks, load_frames

    poses = tum.write_synthetic_tum(str(tmp_path), num_frames=12, camera=CAM, device=dev)
    seq = tum.TumSequence(str(tmp_path))
    eager = [to_floats(rgb, d16, seq.depth_scale, True)
             for rgb, d16 in read_frames([(str(tmp_path / d), str(tmp_path / r)) for _, r, d in seq.pairs])]
    args = argparse.Namespace(dataset=str(tmp_path), synthetic=0, camera="tum", max_frames=None, scale=4,
                              device="cuda")
    frames, cam, gt = load_frames(args)
    slam = FusedDenseFusion(cam, device=dev)
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g, d in chunks(frames, 8, dev):
            assert g.is_cuda and d.is_cuda
            got.append((g, d))
            slam.process_chunk(g, d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    g = torch.cat([x for x, _ in got]).cpu().numpy()
    d = torch.cat([y for _, y in got]).cpu().numpy()
    assert np.array_equal(g, np.stack([x for _, x in eager])) and np.array_equal(d, np.stack([x for x, _ in eager]))
    est, _ = slam.finalize()
    assert traj.ate_rmse(est, gt) < 0.01 and np.allclose(gt, poses, atol=2e-6)


def test_ba_test_tool_on_the_card(dev):
    """`tools/torch_ba_test.py` on the card: full BA in the 2-D model runs
    the BA Schur kernel (2 launches an LM step, nothing else) and ends within
    2x the injected pixel noise and within 10 % of the CPU run's error; the
    pose graph recovers the poses."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import torch_ba_test

    _build.reset_launch_counts()
    card = torch_ba_test.main(["--mode", "full"])
    launches = {k.name: k.launches for k in _build.KERNELS}
    assert launches["ba_schur"] == 2 * 20 and sum(launches.values()) == launches["ba_schur"]
    cpu = torch_ba_test.main(["--mode", "full", "--device", "cpu"])
    assert card["rms_px"] <= 2 * 0.5 and abs(card["rms_px"] - cpu["rms_px"]) <= 0.1 * cpu["rms_px"]
    assert np.isfinite(card["pose_err"])
    assert torch_ba_test.main(["--mode", "posegraph"])["pose_err"] <= 1e-4


def test_loop_closure_detector_kernel_vs_plain(dev):
    """The host-loop LoopClosureDetector on the card (MILD's kernel, one
    launch a query or a batch of queries) against the same database on the
    CPU (the plain version), past a capacity doubling: scores within 1e-5
    relative, candidate lists equal."""
    rng = np.random.default_rng(3)
    n_feat = 500
    kfs = [rng.integers(0, 2**32, (n_feat, 8), dtype=np.uint64).astype(np.uint32).view(np.int32) for _ in range(70)]
    for k in range(40, 70):  # revisits of keyframes 0-29 with a few bits flipped
        kfs[k] = kfs[k - 40] ^ (rng.random((n_feat, 8)) < 0.01).astype(np.int32)
    valid = torch.from_numpy(rng.random(n_feat) > 0.2)
    lcds = {d: mild.LoopClosureDetector(device=d) for d in (dev, torch.device("cpu"))}
    for d, lcd in lcds.items():
        for kf in kfs:
            lcd.insert(torch.from_numpy(kf).to(d), valid.to(d))
    q = torch.from_numpy(np.stack(kfs[60:64]))
    qv = torch.ones((4, n_feat), dtype=torch.bool)
    _build.reset_launch_counts()
    s_k = lcds[dev].similarity(q[0].to(dev), qv[0].to(dev))
    b_k = lcds[dev].similarity_batch(q.to(dev), qv.to(dev))
    assert _build.HAMMING.launches == 2 and lcds[dev].kcap == 128
    s_p = lcds[torch.device("cpu")].similarity(q[0], qv[0])
    b_p = lcds[torch.device("cpu")].similarity_batch(q, qv)
    assert np.abs(s_k - s_p).max() <= 1e-5 * np.abs(s_p).max()
    assert np.abs(b_k - b_p).max() <= 1e-5 * np.abs(b_p).max()
    for i in range(4):
        ck = lcds[dev].candidates_from_sims(b_k[i], 69)
        assert ck == lcds[torch.device("cpu")].candidates_from_sims(b_p[i], 69) and 20 + i in ck


@pytest.mark.parametrize("mode", ["update_frame", "process_chunk"])
def test_baslam_on_the_card_repeats_bit_for_bit(dev, frames, mode):
    """The host-loop BASlam at 160x120 on the card: the Hamming and BA Schur
    kernels launch, the trajectory is finite and close to the ground truth,
    and a second run is bit-equal (poses, world points, observations)."""
    from onepiece_tpu_torch.systems.baslam import BASlam

    poses, grays, depths = frames

    def one():
        s = BASlam(CAM, device=dev, max_keypoints=500, keyframe_disparity=10.0)
        if mode == "update_frame":
            for g, d in zip(grays, depths):
                s.update_frame(g, d)
        else:
            s.process_chunk(grays, depths)
        return s

    _build.reset_launch_counts()
    a = one()
    assert a.optimize() is not None
    assert _build.BA_SCHUR.launches > 0 and _build.HAMMING.launches >= len(grays) - 1
    b = one()
    b.optimize()
    est = a.trajectory()
    assert np.isfinite(est).all() and traj.ate_rmse(est, poses) < 0.05
    assert np.array_equal(est, b.trajectory())
    assert np.array_equal(np.stack(a.world_points), np.stack(b.world_points))
    assert a.observations == b.observations


def _uv_sphere(n_lat: int, n_lon: int, radius: float, centre) -> tuple[np.ndarray, np.ndarray]:
    """A latitude-longitude sphere (V, 3) float32, (F, 3) int64."""
    th = np.linspace(0.05, np.pi - 0.05, n_lat)
    ph = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1).reshape(-1, 3) * radius + centre
    i, j = np.meshgrid(np.arange(n_lat - 1), np.arange(n_lon), indexing="ij")
    a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
    c, d = a + n_lon, b + n_lon
    f = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3), np.stack([b, d, c], -1).reshape(-1, 3)])
    return v.astype(np.float32), f.astype(np.int64)


def _scene_mesh():
    """Two spheres, the smaller occluding the larger, and a quad drawn twice
    at one depth with other colours: 30,004 faces, seeded colours."""
    v1, f1 = _uv_sphere(101, 100, 0.5, (0.0, 0.0, 0.0))
    v2, f2 = _uv_sphere(51, 100, 0.3, (0.3, 0.1, -0.4))
    quad = np.array([[-0.6, -0.6, -0.8], [0.2, -0.6, -0.8], [0.2, 0.2, -0.8], [-0.6, 0.2, -0.8]], np.float32)
    qf = np.array([[0, 1, 2], [0, 2, 3]])
    n = len(v1) + len(v2)
    v = np.concatenate([v1, v2, quad, quad])
    f = np.concatenate([f1, f2 + len(v1), qf + n, qf + n + 4])
    return v, f, np.random.default_rng(0).uniform(0, 1, v.shape).astype(np.float32)


@pytest.mark.parametrize("coloured", [False, True])
def test_render_mesh_on_the_card_against_the_cpu(dev, coloured):
    """`viz/render.render_mesh` at 640x480 on the card against the CPU, in
    whole and in small chunks: at least 99.9 % of pixels equal (the same
    float64 expressions; here every pixel)."""
    from onepiece_tpu_torch.geometry.camera import PinholeCamera
    from onepiece_tpu_torch.viz import render

    v, f, c = _scene_mesh()
    cam = PinholeCamera(fx=576.0, fy=576.0, cx=319.5, cy=239.5, width=640, height=480, depth_scale=1000.0)
    c = c if coloured else None
    for tz in (-2.0, -1.1):
        T = np.eye(4)
        T[:3, 3] = [0.05, 0.02, tz]
        ref = render.render_mesh(torch.from_numpy(v), torch.from_numpy(f), cam, T,
                                 None if c is None else torch.from_numpy(c)).numpy()
        args = (torch.from_numpy(v).to(dev), torch.from_numpy(f).to(dev), cam, T,
                None if c is None else torch.from_numpy(c).to(dev))
        img = render.render_mesh(*args)
        assert img.device.type == "cuda" and (ref.sum(-1) > 0).mean() > 0.2
        assert (img.cpu().numpy() == ref).all(-1).mean() >= 0.999
        budget = render.FRAGMENT_BUDGET
        try:
            render.FRAGMENT_BUDGET = 10_000
            assert torch.equal(render.render_mesh(*args), img)
        finally:
            render.FRAGMENT_BUDGET = budget


def test_triangle_mesh_on_the_card_repeats_bit_for_bit(dev):
    """`TriangleMesh`'s device ops (vertex normals, clustering simplification,
    pruning's compaction) twice on the card: bit-equal run to run (segment
    sums in a fixed order, no float atomics), and against the CPU faces
    equal and vertices, normals and colours within 1e-6."""
    from onepiece_tpu_torch.geometry.mesh import TriangleMesh

    v, f, c = _scene_mesh()
    rng = np.random.default_rng(1)
    v = v + rng.normal(0, 0.002, v.shape).astype(np.float32)
    host = TriangleMesh.from_numpy(v, f, c, device="cpu")
    ops = {
        "normals": lambda m: TriangleMesh(m.vertices, m.faces, m.colors).compute_vertex_normals(),
        "cluster 0.02": lambda m: m.clustering_simplify(0.02),
        "cluster 0.005": lambda m: m.clustering_simplify(0.005),
        "prune": lambda m: m.prune(100),
    }
    for name, op in ops.items():
        a, b = (op(TriangleMesh.from_numpy(v, f, c, device=dev)) for _ in range(2))
        ref = op(host)
        for field in ("vertices", "faces", "colors", "normals"):
            x, y, r = getattr(a, field), getattr(b, field), getattr(ref, field)
            if r is None:
                assert x is None and y is None, (name, field)
                continue
            assert x.device.type == "cuda" and torch.equal(x, y), (name, field)
            if field == "faces":
                assert torch.equal(x.cpu(), r), name
            else:
                assert float((x.cpu() - r).abs().max()) <= 1e-6, (name, field)


# ---- parallel/ on the card ---------------------------------------------------


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_collectives_on_cuda_tensors(dev, world, backend):
    """`comm.py`'s four collectives on CUDA tensors: NCCL carries them as
    they are (one card: world 1), gloo through explicit host copies (ranks
    sharing the card); values exact, results on the card, staging counted."""
    from onepiece_tpu_torch.parallel import launch
    from torch_parallel_ranks import collectives, expected_collectives

    for r, got in enumerate(launch.spawn(world, collectives, backend=backend, device="cuda", timeout=240)):
        for name, want in expected_collectives(r, world).items():
            assert np.array_equal(got[name], want), (name, got[name], want)
            assert got["devices"][name].startswith("cuda"), got["devices"]
            staged = got["stats"][name]["staged_bytes"]
            assert (staged > 0) if backend == "gloo" else (staged == 0), (name, staged)


def test_nccl_refuses_more_ranks_than_cards(dev):
    from onepiece_tpu_torch.parallel import launch
    from torch_parallel_ranks import collectives

    with pytest.raises(RuntimeError, match="backend='gloo'"):
        launch.spawn(torch.cuda.device_count() + 1, collectives, backend="nccl", device="cuda")


@pytest.mark.parametrize("model", ["3d", "2d"])
@pytest.mark.parametrize("case", ["orbit", "loop", "frame_without_observations", "two_in_one_frame"])
def test_ba_schur_kernel_undamped_u_vs_plain(dev, case, model):
    """`reduced_system(undamped_u=True)` (the point-sharded step's call):
    the kernel's U blocks, its S (U undamped on the diagonal) and rhs_c
    within 1e-4 of the plain version's largest entry, at the damping LM
    reaches after rejections (phase 10's rule for both models there);
    damping the kernel's U afterwards gives the damped call's S; one launch
    a call, two calls bit-equal."""
    from onepiece_tpu_torch.ops.ba_schur import damp

    args, _ = _ba_problem(case, model, dev)
    args = (*args[:6], torch.tensor(BA_DAMPINGS[0], device=dev), *args[7:])
    frame, point, valid, lam = args[2], args[3], args[5], args[6]
    F = args[0].shape[0]
    lists = ba_schur.build_lists(frame, point, valid, F, args[1].shape[0])
    _build.reset_launch_counts()
    k = ba_schur.reduced_system(*args, lists=lists, undamped_u=True)
    assert _build.BA_SCHUR.launches == 1
    k2 = ba_schur.reduced_system(*args, lists=lists, undamped_u=True)
    p = ba_schur.reduced_system_reference(*args, undamped_u=True)
    damped = ba_schur.reduced_system(*args, lists=lists)
    torch.cuda.synchronize()
    for name in ("S", "rhs_c", "U"):
        assert torch.equal(getattr(k, name), getattr(k2, name)), name
        assert _rel(getattr(k, name), getattr(p, name)) <= 1e-4, (name, _rel(getattr(k, name), getattr(p, name)))
    redamped = k.S + torch.block_diag(*(damp(k.U, lam) - k.U))
    assert _rel(redamped, damped.S) <= 1e-6
    assert torch.equal(k.rhs_c, damped.rhs_c) and torch.equal(k.Vinv, damped.Vinv)


def test_marching_cubes_on_extended_pools(dev, frames):
    """The marching-cubes kernel on each shard's pool with the halo rows
    appended and the neighbour slots remapped (`parallel/mc.py`), for 2 and
    3 shards of a fused volume: the shards' triangles, in shard order, equal
    the kernel's on the unsharded pool, bit for bit."""
    from onepiece_tpu_torch.parallel import mc as pmc

    _, grays, depths = frames
    slam = FusedDenseFusion(CAM, device=dev, capacity=4096, table_size=1 << 14)
    slam.process_chunk(grays, depths)
    st = slam._state
    whole = pmc.local_blocks(st.table, 0, slam.capacity)
    want_v, want_c = mc.extract_triangles(st.vox, whole[0], whole[2], whole[1].contiguous(), slam.voxel_size)
    assert want_v.shape[0] > 1000
    for world in (2, 3):
        cap_l = -(-slam.num_active // world)  # every shard holds blocks
        got_v, got_c = [], []
        for r in range(world):
            lo = r * cap_l
            slots, coords, nbr = pmc.local_blocks(st.table, lo, cap_l)
            want = pmc.halo_slots(nbr, lo, cap_l)
            assert want.numel() > 0
            vox_l = torch.cat([st.vox[lo : lo + cap_l], st.vox[-1:]])
            ext, nbr_ext = pmc.extended_pool(vox_l, st.vox[want.long()], want, nbr, lo)
            v, c = mc.extract_triangles(ext, slots, nbr_ext, coords.contiguous(), slam.voxel_size)
            got_v.append(v)
            got_c.append(c)
        assert torch.equal(torch.cat(got_v), want_v) and torch.equal(torch.cat(got_c), want_c), world


def test_scannet_model_on_the_card_against_the_cpu(dev, tmp_path):
    """`tools/torch_scannet_model.reconstruct` on the committed ScanNet
    fixture (its 1296x968 JPEGs, 640x480 depth rendered here at its poses,
    frame 7 lost) on the card against its device="cpu" run: 7 frames
    integrated (7 TSDF launches), blocks within 1 %, triangles within 2 %,
    the pools voxel by voxel by `chip_smoke.pool_band` (weights equal, sdf
    within 5e-4, colour within 5e-3, at most 1e-4 of the seen voxels
    outside), and the card's pool meshed by the plain version equals the
    kernel's mesh (one marching-cubes launch)."""
    import json
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo / "tools"))
    sys.path.insert(0, str(repo))
    import chip_smoke
    import torch_make_scannet_fixture as fixture
    import torch_scannet_model

    manifest = json.loads((Path(fixture.FIXTURE_DIR) / "manifest.json").read_text())
    poses = np.asarray(manifest["poses"], np.float32)
    c = fixture.DEPTH_CAMERA
    scene = synthetic.default_scene(dev)
    depths = [synthetic.render(scene, torch.from_numpy(p).to(dev), c.fx, c.fy, c.cx, c.cy, c.height, c.width,
                               num_steps=manifest["render_steps"])[0].cpu().numpy() for p in poses]
    jpegs = [(Path(fixture.FIXTURE_DIR) / f["file"]).read_bytes() for f in manifest["frames"]]
    fixture.write_export(str(tmp_path), np.stack(depths), poses, fixture.COLOR_CAMERA, c, jpegs, untracked=(7,))
    _build.reset_launch_counts()
    vk, used = torch_scannet_model.reconstruct(str(tmp_path), 0.02, 1, device="cuda", log=lambda s: None)
    tvk, tck = vk.extract_mesh()
    assert used == 7 and _build.TSDF_INTEGRATE.launches == 7 and _build.MARCHING_CUBES.launches == 1
    vc, _ = torch_scannet_model.reconstruct(str(tmp_path), 0.02, 1, device="cpu", log=lambda s: None)
    tvc, _ = vc.extract_mesh()
    assert abs(vk.num_active - vc.num_active) <= 0.01 * vc.num_active
    assert abs(len(tvk) - len(tvc)) <= 0.02 * len(tvc) and len(tvk) > 10000
    sdf_tol, color_tol, share = chip_smoke.SCANNET_VOXEL_BAND
    outside, seen, _, _ = chip_smoke.pool_band(vk, vc, sdf_tol, color_tol)
    assert seen > 10000 and outside <= share * seen
    na = vk.num_active
    coords = torch.from_numpy(vk.active_coords()).int()
    vp, cp = mc.extract_triangles_reference(vk.vox.cpu(), torch.arange(na, dtype=torch.int32),
                                            neighbor_slots_device(coords), coords, vk.voxel_size)
    np.testing.assert_array_equal(tvk, vp.numpy())
    np.testing.assert_array_equal(tck, cp.numpy())
