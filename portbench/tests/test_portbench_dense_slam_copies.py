"""The DenseFusion reference's frozen copies (`reference/registration.py`,
`reference/dense_slam.py`) against their sources in the port, on the
port's plain (CPU) path, bit for bit: k-NN and ICP's 1-NN, a submap's
cloud steps, normals and FPFH, ICP, global registration with its seeded
draws, the pose graph, one tracked pair and the post-hoc volume."""

from __future__ import annotations

import numpy as np
import torch
from conftest import TINY_CAMERA

from onepiece_tpu_torch.geometry import pointcloud
from onepiece_tpu_torch.geometry.camera import PinholeCamera
from onepiece_tpu_torch.odometry import dense
from onepiece_tpu_torch.ops import knn as port_knn
from onepiece_tpu_torch.ops import nn1 as port_nn1
from onepiece_tpu_torch.optimization import posegraph as port_pg
from onepiece_tpu_torch.registration import global_reg, icp
from onepiece_tpu_torch.systems import dense_slam as ds
from portbench import run
from portbench.reference import dense_slam as ref
from portbench.reference import registration as R
from portbench.reference.fused_dense_fusion import pool_gaps
from portbench.traffic import closed_scans


def _cfg():
    _, cfg, mix = run.load_cell("densefusion.lap300")
    return {**cfg, "camera": {**cfg["camera"], **TINY_CAMERA}, "voxel_size": 0.1}, {
        **mix, "loop_frames": 12, "scan_frames": 12, "render_steps": 32, "render_batch": 6}


def _frames():
    cfg, mix = _cfg()
    return cfg, closed_scans.make_frames(cfg, mix, 2**31 + 9, torch.device("cpu")).scan(0, 12)


def _cam(cfg) -> PinholeCamera:
    return PinholeCamera(**cfg["camera"])


def test_nearest_neighbours_are_the_ports():
    g = torch.Generator().manual_seed(1)
    q, r = torch.randn(300, 3, generator=g), torch.randn(500, 3, generator=g)
    v = torch.rand(500, generator=g) > 0.3
    for k in (1, 16):
        a, b = R.knn(q, r, v, k), port_knn.knn(q, r, v, k)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    a, b = R.nn1(q, r, v), port_nn1.nn1_reference(q, r, v)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _submap(cfg, d, rel):
    cam = _cam(cfg)
    port = [pointcloud.PointCloud.from_rgbd(d[f], None, cam, dense.MIN_DEPTH, dense.MAX_DEPTH).transform(
        torch.from_numpy(rel[f])) for f in range(0, 4, 3)]
    return pointcloud.compact(pointcloud.voxel_downsample(pointcloud.merge(*port), cfg["voxel_size"]))


def test_submap_cloud_features_icp_and_registration_are_the_ports():
    cfg, (g, d, c) = _frames()
    rel = np.stack([np.eye(4, dtype=np.float32)] * 12)
    rel[3, :3, 3] = [0.01, -0.02, 0.03]
    port = _submap(cfg, d, rel)
    ours = ref.submap_cloud(d, rel, [0, 3], cfg)
    for a, b in zip((port.points, port.normals, port.colors, port.valid), ours):
        assert torch.equal(a, b)
    params = global_reg.RansacParams(voxel_size=cfg["voxel_size"])
    pf = global_reg.extract_features(port, params)
    of = R.extract_features(ours, cfg)
    assert all(torch.equal(a, b) for a, b in zip(pf, of))
    other = ref.submap_cloud(d, rel, [6, 9], cfg)
    pf2, of2 = global_reg.extract_features(pointcloud.PointCloud(*other), params), R.extract_features(other, cfg)
    init = torch.eye(4)
    pi = icp.point_to_point(port.points, port.valid, other.points, other.valid, init_T=init, threshold=0.1)
    oi = R.icp(ours.points, ours.valid, other.points, other.valid, init, 0.1, cfg["icp_iters"])
    assert torch.equal(pi.T, oi[0]) and torch.equal(pi.num_inliers, oi[1]) and torch.equal(pi.rmse, oi[2])
    pr, orr = global_reg.register(pf, pf2, params), R.register(of, of2, cfg)
    assert torch.equal(pr.T, orr.T) and torch.equal(pr.num_inliers, orr.num_inliers)


def test_pose_graph_and_tracking_are_the_ports():
    cfg, (g, d, c) = _frames()
    gen = np.random.default_rng(3)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[1:, :3, 3] = gen.normal(size=(2, 3)) * 0.1
    edges = []
    for s, t in ((1, 0), (2, 1), (2, 0)):
        p = gen.normal(size=(40, 3)).astype(np.float32)
        edges.append({"src": s, "dst": t, "p_src": p, "p_dst": p + gen.normal(size=3).astype(np.float32) * 0.05})
    packed = port_pg.build_edges(edges, corr_capacity=ds.MAX_EDGE_CORRS)
    want = port_pg.optimize_pose_graph(torch.from_numpy(poses), packed, iters=5)[0].numpy()
    assert np.array_equal(ref.solve(poses, edges, cfg, "cpu"), want)
    cam = _cam(cfg)
    a = dense.preprocess_frame(g[4], d[4], cam)
    b = dense.preprocess_frame(g[5], d[5], cam)
    assert torch.equal(ref.track_pair(g[4], d[4], g[5], d[5], cfg), dense.dense_tracking(a, b, cam).T_ts)


def test_posthoc_volume_is_the_ports():
    cfg, (g, d, c) = _frames()
    poses = np.stack([np.eye(4, dtype=np.float32)] * 12)
    poses[:, 0, 3] = np.linspace(0.0, 0.05, 12)
    kept = ((i, d[i], c[i]) for i in range(0, 12, cfg["posthoc_stride"]))
    vol, _ = ds.reconstruct(poses, kept, _cam(cfg), cfg["posthoc_voxel"], "cpu")
    pool = ref.posthoc_pool(d, c, poses, cfg)
    coords = torch.from_numpy(vol.block_coords[: vol.num_active]).to(torch.int32)
    assert pool.coords.shape == coords.shape
    assert pool_gaps(vol.vox, coords, pool) == dict(weight_mismatch=0.0, sdf_gap=0.0, color_gap=0.0)
