"""The port's registration modules against the JAX package's, on the CPU.

Inputs are made from seeded numpy and fed to both packages in one process
(JAX pinned to the CPU by `tests/conftest.py`; the port runs its plain
versions). Tolerances, and why:
  - nn1 (plain version vs the Pallas kernel in interpret mode): d2 to rtol
    1e-6; indices equal except where JAX's two best distances lie within
    1e-6 (relative) of each other; an all-invalid reference set gives
    (0, 1e30); duplicated references resolve to the lowest index;
  - knn / radius_knn (k = 1, 16, 32): distances 1e-5, index sets equal
    away from near-ties (both use the expansion form; the port's squared
    norms follow XLA's FMA chain, so on the CPU the distances agree bit
    for bit);
  - kabsch, kabsch_fast, estimate_normals_from_neighbors: 1e-5 (normals up
    to sign: an eigenvector's sign is arbitrary);
  - PointCloud: voxel_downsample gives the same voxels and count and the
    averaged points to 1e-6; compact exact; estimate_normals 1e-4 on every
    point whose 12 neighbours are the same in both (all but a near-tie);
  - point_to_point / point_to_plane ICP: T to 1e-4 (JAX's CPU path finds
    neighbours with the expansion form of ops/knn.py, the port with nn1's
    difference form, so a few near-tie correspondences differ);
  - compute_fpfh: at least 99 % of rows within 1e-3 on identical inputs (a
    bin edge may move one count); through each package's own downsample
    and normals, 90 % (normals ~3e-7 apart move more angles across edges);
  - ransac_rigid, ransapc_filter and register, with the JAX package's
    sample indices fed in (the two RNGs differ): masks and best count
    equal, T to 1e-4 (register 1e-3);
  - optimize_pose_graph on a 5-pose graph with repeated edge indices: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry import pointcloud as jpc
from onepiece_tpu.geometry import se3 as jse3
from onepiece_tpu.geometry import transforms as jtf
from onepiece_tpu.ops import knn as jknn
from onepiece_tpu.ops import knn_pallas as jknp
from onepiece_tpu.ops import ransac as jransac
from onepiece_tpu.optimization import posegraph as jpg
from onepiece_tpu.registration import global_reg as jgr
from onepiece_tpu.registration import icp as jicp
from onepiece_tpu_torch.geometry import pointcloud as tpc
from onepiece_tpu_torch.geometry import se3 as tse3
from onepiece_tpu_torch.geometry import transforms as ttf
from onepiece_tpu_torch.ops import knn as tknn
from onepiece_tpu_torch.ops import nn1 as tnn1
from onepiece_tpu_torch.ops import ransac as transac
from onepiece_tpu_torch.optimization import posegraph as tpg
from onepiece_tpu_torch.registration import fpfh as tfpfh
from onepiece_tpu_torch.registration import global_reg as tgr
from onepiece_tpu_torch.registration import icp as ticp


def T(x):
    return torch.from_numpy(np.asarray(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_surface(n, seed=21):
    """A bumpy non-symmetric surface patch (as tests/test_registration.py)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, size=(n, 2))
    z = (0.3 * np.sin(2.5 * xy[:, 0]) + 0.2 * np.cos(3.1 * xy[:, 1] + 0.7)
         + 0.15 * np.sin(1.7 * (xy[:, 0] + xy[:, 1])))
    return np.c_[xy, z].astype(np.float32)


def _near_tie(d_sorted, i):
    """Row i's two best distances (ascending, JAX's) within 1e-6 relative."""
    return d_sorted[i, 1] - d_sorted[i, 0] <= 1e-6 * max(d_sorted[i, 1], 1e-30)


# ---- nn1: the kernel's plain version vs the Pallas kernel -----------------

def _nn1_case(name):
    rng = np.random.default_rng(5)
    if name == "ragged":  # sizes that are not multiples of 256 or 2048
        q = rng.normal(size=(1000, 3)).astype(np.float32)
        r = rng.normal(size=(2100, 3)).astype(np.float32)
        v = rng.random(2100) > 0.2  # 20 % invalid
    elif name == "all_invalid":
        q = rng.normal(size=(300, 3)).astype(np.float32)
        r = rng.normal(size=(700, 3)).astype(np.float32)
        v = np.zeros(700, bool)
    else:  # duplicated references: ties go to the lowest index
        base = rng.normal(size=(600, 3)).astype(np.float32)
        r = np.concatenate([base, base[::-1], base[:300]])
        v = np.ones(len(r), bool)
        v[:50] = False  # an invalid copy must not win
        q = np.concatenate([base[:400], rng.normal(size=(333, 3)).astype(np.float32)])
    return q, r, v


@pytest.mark.parametrize("case", ["ragged", "all_invalid", "duplicates"])
def test_nn1_reference_matches_pallas(case):
    q, r, v = _nn1_case(case)
    ij, dj = (np.asarray(a) for a in jknp.nn1_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(v),
                                                     interpret=True))
    it, dt = (N(a) for a in tnn1.nn1_reference(T(q), T(r), T(v)))
    assert it.dtype == np.int32 and dt.dtype == np.float32 and it.shape == dt.shape == (len(q),)
    np.testing.assert_allclose(dt, dj, rtol=1e-6)
    if case == "all_invalid":
        assert (it == 0).all() and (dt == np.float32(1e30)).all()
        assert (ij == 0).all()
        return
    d_all = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
    d_all[:, ~v] = np.inf
    d_sorted = np.sort(d_all, axis=1)
    differ = np.nonzero(it != ij)[0]
    assert all(_near_tie(d_sorted, i) for i in differ), differ
    assert v[it].all()
    if case == "duplicates":
        # exact duplicates: the lowest valid copy of the point wins
        first = {tuple(p): k for k, p in reversed(list(enumerate(r.tolist()))) if v[k]}
        assert [first[tuple(p)] for p in q[:400].tolist()] == it[:400].tolist()
        assert it[:400].tolist() == ij[:400].tolist()


def test_nn1_dispatches_to_plain_on_cpu():
    q, r, v = _nn1_case("ragged")
    a = tnn1.nn1(T(q), T(r), T(v))
    b = tnn1.nn1_reference(T(q), T(r), T(v))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    i0, d0 = tnn1.nn1(T(q), T(r[:0]), T(v[:0]))  # no reference at all
    assert (i0 == 0).all() and (d0 == np.float32(1e30)).all()


# ---- knn ------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 16, 32])
def test_knn_matches_jax(k):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2500, 3)).astype(np.float32)  # > one 2048-row tile
    r = rng.normal(size=(1500, 3)).astype(np.float32)
    v = rng.random(1500) > 0.1
    ij, dj = (np.asarray(a) for a in jknn.radius_knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(v),
                                                     k=k, radius=0.5)[:2])
    it, dt, mt = tknn.radius_knn(T(q), T(r), T(v), k=k, radius=0.5)
    assert it.shape == dt.shape == mt.shape == (2500, k)
    np.testing.assert_allclose(N(dt), dj, atol=1e-5)
    np.testing.assert_array_equal(N(mt), dj <= np.float32(0.25))
    # index sets equal wherever the k-th and (k+1)-th distances are apart
    d_all = np.sort(np.where(v[None], ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1), np.inf), 1)
    clear = d_all[:, k] - d_all[:, k - 1] > 1e-5
    if k == 1:
        clear &= d_all[:, 1] - d_all[:, 0] > 1e-5
    assert clear.mean() > 0.99
    for i in np.nonzero(clear)[0]:
        assert set(N(it[i]).tolist()) == set(ij[i].tolist())


# ---- transforms -----------------------------------------------------------

def _batch_pairs(seed=3, b=64, n=12):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, n, 3)).astype(np.float32)
    xi = (rng.normal(size=(b, 6)) * 0.4).astype(np.float32)
    Tg = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    dst = (np.einsum("bij,bnj->bni", Tg[:, :3, :3], src) + Tg[:, None, :3, 3]
           + rng.normal(size=src.shape).astype(np.float32) * 0.01).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=(b, n)).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("fn", ["kabsch", "kabsch_fast"])
def test_kabsch_matches_jax(fn):
    src, dst, w = _batch_pairs()
    tj = np.asarray(getattr(jtf, fn)(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    tt = N(getattr(ttf, fn)(T(src), T(dst), T(w)))
    assert tt.shape == (64, 4, 4)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    # unweighted, one problem
    tj1 = np.asarray(getattr(jtf, fn)(jnp.asarray(src[0]), jnp.asarray(dst[0])))
    np.testing.assert_allclose(N(getattr(ttf, fn)(T(src[0]), T(dst[0]))), tj1, atol=1e-5)


def test_kabsch_reflection_case_matches_jax():
    src, _, _ = _batch_pairs(b=4)
    dst = src * np.float32([-1, 1, 1])  # a mirror image: det(U Vt) = -1
    np.testing.assert_allclose(N(ttf.kabsch(T(src), T(dst))),
                               np.asarray(jtf.kabsch(jnp.asarray(src), jnp.asarray(dst))), atol=1e-5)


def test_estimate_normals_from_neighbors_matches_jax():
    rng = np.random.default_rng(4)
    nb = rng.normal(size=(200, 16, 3)).astype(np.float32) * np.float32([1.0, 0.6, 0.05])
    valid = rng.random((200, 16)) > 0.2
    nj = np.asarray(jtf.estimate_normals_from_neighbors(jnp.asarray(nb), jnp.asarray(valid)))
    nt = N(ttf.estimate_normals_from_neighbors(T(nb), T(valid)))
    sign = np.sign(np.sum(nj * nt, -1, keepdims=True))
    np.testing.assert_allclose(nt * sign, nj, atol=1e-5)


def test_transform_normals_matches_jax():
    rng = np.random.default_rng(6)
    Tm = np.asarray(jse3.se3_exp(jnp.asarray([0.1, -0.2, 0.3, 0.4, -0.5, 0.6], jnp.float32)))
    n = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tse3.transform_normals(T(Tm), T(n))),
                               np.asarray(jse3.transform_normals(jnp.asarray(Tm), jnp.asarray(n))),
                               atol=1e-6)


# ---- point clouds ---------------------------------------------------------

def _both_clouds(pts, normals=None, colors=None, capacity=None):
    cj = jpc.PointCloud.from_numpy(pts, normals, colors, capacity=capacity)
    ct = tpc.PointCloud.from_numpy(pts, normals, colors, capacity=capacity)
    for f in ("points", "normals", "colors", "valid"):
        np.testing.assert_array_equal(N(getattr(ct, f)), np.asarray(getattr(cj, f)))
    return cj, ct


def test_voxel_downsample_and_compact_match_jax():
    rng = np.random.default_rng(8)
    pts = (rng.normal(size=(5000, 3)) * [0.6, 0.4, 0.8]).astype(np.float32)
    nrm = rng.normal(size=(5000, 3)).astype(np.float32)
    col = rng.random((5000, 3)).astype(np.float32)
    cj, ct = _both_clouds(pts, nrm, col, capacity=6000)  # 1000 invalid entries
    dj = jpc.voxel_downsample(cj, 0.1)
    dt = tpc.voxel_downsample(ct, 0.1)
    vj, vt = np.asarray(dj.valid), N(dt.valid)
    np.testing.assert_array_equal(vt, vj)
    assert 100 < vt.sum() < 5000
    np.testing.assert_array_equal(
        N(tpc._voxel_keys(ct.points, ct.valid, 0.1)),
        np.asarray(jpc._voxel_keys(cj.points, cj.valid, 0.1)))
    for f in ("points", "normals", "colors"):
        np.testing.assert_allclose(N(getattr(dt, f))[vt], np.asarray(getattr(dj, f))[vj], atol=1e-6)
    # compact: exact, same capacity bucket
    kj, kt = jpc.compact(dj), tpc.compact(dt)
    assert kt.capacity == kj.capacity
    np.testing.assert_array_equal(N(kt.valid), np.asarray(kj.valid))
    mj = jpc.compact(cj)
    mt = tpc.compact(ct)
    for f in ("points", "normals", "colors", "valid"):
        np.testing.assert_array_equal(N(getattr(mt, f)), np.asarray(getattr(mj, f)))
    for a, b in zip(mt.to_numpy(), mj.to_numpy()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(N(tpc.merge(kt, mt).points), np.asarray(jpc.merge(kj, mj).points))


def test_from_rgbd_and_transform_match_jax():
    from onepiece_tpu.geometry.camera import PinholeCamera as JCam
    from onepiece_tpu_torch.geometry.camera import PinholeCamera as TCam

    kw = dict(fx=50.0, fy=50.0, cx=39.5, cy=29.5, width=80, height=60, depth_scale=1000.0)
    rng = np.random.default_rng(9)
    depth = rng.uniform(0.2, 5.0, size=(60, 80)).astype(np.float32)
    depth[rng.random((60, 80)) < 0.1] = 0.0
    Tm = np.asarray(jse3.se3_exp(jnp.asarray([0.1, -0.2, 0.3, 0.04, -0.05, 0.06], jnp.float32)))
    cj = jpc.PointCloud.from_rgbd(jnp.asarray(depth), None, JCam(**kw), 0.5, 4.0).transform(jnp.asarray(Tm))
    ct = tpc.PointCloud.from_rgbd(T(depth), None, TCam(**kw), 0.5, 4.0).transform(T(Tm))
    np.testing.assert_array_equal(N(ct.valid), np.asarray(cj.valid))
    np.testing.assert_allclose(N(ct.points), np.asarray(cj.points), atol=1e-5)


def test_estimate_normals_matches_jax():
    pts = make_surface(1500)
    cj, ct = _both_clouds(pts, capacity=2048)
    nj = np.asarray(jpc.estimate_normals(cj, k=12).normals)
    nt = N(tpc.estimate_normals(ct, k=12).normals)
    # every valid point has 12 non-degenerate neighbours (the surface
    # samples are in general position); a near-tie at the 12th neighbour
    # gives the packages different neighbour sets, and is left out
    ij = np.asarray(jknn.knn(cj.points, cj.points, cj.valid, k=12)[0])
    it = N(tknn.knn(ct.points, ct.points, ct.valid, k=12)[0])
    v = np.asarray(cj.valid)
    same = v & np.array([set(a) == set(b) for a, b in zip(ij.tolist(), it.tolist())])
    assert same.sum() >= 0.995 * v.sum()
    np.testing.assert_allclose(nt[same], nj[same], atol=1e-4)
    assert (nt[~v] == 0).all()


# ---- ICP ------------------------------------------------------------------

def test_icp_point_to_point_matches_jax():
    pts = make_surface(2000)
    Tg = jse3.se3_exp(jnp.asarray([0.05, -0.03, 0.04, 0.05, -0.04, 0.06], jnp.float32))
    dst = np.asarray(jse3.transform_points(Tg, jnp.asarray(pts)))
    v = np.ones(len(pts), bool)
    v[::17] = False
    rj = jicp.point_to_point(jnp.asarray(pts), jnp.asarray(v), jnp.asarray(dst), jnp.asarray(v), threshold=0.3)
    rt = ticp.point_to_point(T(pts), T(v), T(dst), T(v), threshold=0.3)
    np.testing.assert_allclose(N(rt.T), np.asarray(rj.T), atol=1e-4)
    np.testing.assert_allclose(N(rt.T), np.asarray(Tg), atol=2e-3)
    assert int(rt.num_inliers) == int(rj.num_inliers)
    # a perfect fit: JAX's expansion-form distances carry ~1e-8 m^2 of
    # cancellation (rmse ~1.6e-4 m), nn1's difference form does not
    assert float(rt.rmse) <= float(rj.rmse) + 1e-6 and float(rj.rmse) < 3e-4


def test_icp_point_to_plane_matches_jax():
    pts = make_surface(2000)
    Tg = jse3.se3_exp(jnp.asarray([0.04, 0.02, -0.03, 0.03, 0.05, -0.02], jnp.float32))
    dst_pts = np.asarray(jse3.transform_points(Tg, jnp.asarray(pts)))
    cj = jpc.estimate_normals(jpc.PointCloud.from_numpy(dst_pts), k=12)
    nrm = np.asarray(cj.normals)[: len(pts)]  # both get the same target normals
    v = np.ones(len(pts), bool)
    init = np.asarray(jse3.se3_exp(jnp.asarray([0.01, 0.0, 0.01, 0.0, 0.02, 0.0], jnp.float32)))
    rj = jicp.point_to_plane(jnp.asarray(pts), jnp.asarray(v), jnp.asarray(dst_pts), jnp.asarray(nrm),
                             jnp.asarray(v), init_T=jnp.asarray(init), threshold=0.3, iters=20)
    rt = ticp.point_to_plane(T(pts), T(v), T(dst_pts), T(nrm), T(v), init_T=T(init), threshold=0.3, iters=20)
    np.testing.assert_allclose(N(rt.T), np.asarray(rj.T), atol=1e-4)
    np.testing.assert_allclose(N(rt.T), np.asarray(Tg), atol=3e-3)
    assert abs(float(rt.rmse) - float(rj.rmse)) <= 1e-4


# ---- FPFH, RANSAC, global registration ------------------------------------

@pytest.fixture(scope="module")
def features():
    """Both packages' features of the surface and of a moved copy
    (test_registration.py's large-motion case)."""
    pts = make_surface(4000)
    cloud = jpc.PointCloud.from_numpy(pts)
    Tg = jse3.se3_exp(jnp.asarray([0.4, -0.3, 0.5, 0.3, 0.5, -0.4], jnp.float32))
    params = dict(voxel_size=0.08, fpfh_radius=0.3, threshold=0.1)
    pj, pt = jgr.RansacParams(**params), tgr.RansacParams(**params)
    out = {}
    for name, c in (("src", cloud), ("tgt", cloud.transform(Tg))):
        fj = jgr.downsample_and_extract(c, pj)
        ct = tpc.PointCloud(*(T(np.asarray(getattr(c, f))) for f in ("points", "normals", "colors", "valid")))
        out[name] = (fj, tgr.downsample_and_extract(ct, pt))
    return out, pj, pt, np.asarray(Tg)


def test_downsample_and_extract_and_fpfh_match_jax(features):
    feats = features[0]
    for fj, ft in feats.values():
        v = np.asarray(fj.valid)
        np.testing.assert_array_equal(N(ft.valid), v)
        np.testing.assert_allclose(N(ft.points), np.asarray(fj.points), atol=1e-6)
        np.testing.assert_allclose(N(ft.normals)[v], np.asarray(fj.normals)[v], atol=1e-5)
        # each package's own normals (eigh: <= ~3e-7 apart) move a few pair
        # angles across a bin edge, and one moved count in a neighbour's
        # histogram reaches up to k = 32 rows
        rows = np.abs(N(ft.fpfh)[v] - np.asarray(fj.fpfh)[v]).max(axis=1) <= 1e-3
        assert rows.mean() >= 0.9, rows.mean()
    # compute_fpfh alone, on identical inputs: JAX's features of its own
    # points and normals
    fj = feats["src"][0]
    a = np.asarray(fj.fpfh)
    b = N(tfpfh.compute_fpfh(T(fj.points), T(fj.normals), T(fj.valid), radius=0.3))
    assert (np.abs(a - b).max(axis=1) <= 1e-3).mean() >= 0.99
    assert (b[~np.asarray(fj.valid)] == 0).all()


def _jax_features_as_torch(fj):
    return tgr.CloudFeatures(*(T(np.asarray(a)) for a in fj))


def test_ransac_rigid_and_ransapc_match_jax_with_fed_samples():
    rng = np.random.default_rng(11)
    src = make_surface(600, seed=3)
    Tg = np.asarray(jse3.se3_exp(jnp.asarray([0.2, -0.1, 0.3, 0.2, -0.3, 0.1], jnp.float32)))
    dst = src @ Tg[:3, :3].T + Tg[:3, 3]
    out = rng.random(600) < 0.4  # 40 % outliers
    dst[out] = rng.uniform(-1, 1, size=(out.sum(), 3))
    dst = (dst + rng.normal(size=dst.shape) * 0.005).astype(np.float32)
    valid = rng.random(600) > 0.05
    key = jax.random.PRNGKey(3)
    args_j = (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid))
    args_t = (T(src), T(dst), T(valid))

    anchors = np.asarray(jransac._sample_indices(key, jnp.asarray(valid), 1, 8)[0])
    mj = np.asarray(jransac.ransapc_filter(key, *args_j, tolerance=0.15))
    mt = N(transac.ransapc_filter(None, *args_t, tolerance=0.15, samples=T(anchors)))
    np.testing.assert_array_equal(mt, mj)

    hyp = np.asarray(jransac._sample_indices(key, jnp.asarray(valid), 512, 4))
    rj = jransac.ransac_rigid(key, *args_j, threshold=0.05, num_hypotheses=512, sample_size=4)
    rt = transac.ransac_rigid(None, *args_t, threshold=0.05, num_hypotheses=512, sample_size=4,
                              samples=T(hyp))
    assert int(rt.num_inliers) == int(rj.num_inliers) > 300
    np.testing.assert_array_equal(N(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(N(rt.T), np.asarray(rj.T), atol=1e-4)
    assert abs(float(rt.rmse) - float(rj.rmse)) <= 1e-5


def test_sample_indices_draw_valid_distinct_entries():
    valid = torch.from_numpy(np.random.default_rng(2).random(300) > 0.5)
    gen = torch.Generator().manual_seed(0)
    idx = transac.sample_indices(gen, valid, 64, 4)
    assert idx.shape == (64, 4) and bool(valid[idx].all())
    assert all(len(set(row.tolist())) == 4 for row in idx)
    again = transac.sample_indices(torch.Generator().manual_seed(0), valid, 64, 4)
    assert torch.equal(idx, again)  # explicit generator: reproducible


def jax_register_samples(src, tgt, params):
    """The sample indices JAX's `register` draws with its default key."""
    keys = jax.random.split(jax.random.PRNGKey(0), params.ransapc_rounds + 1)
    idx = jknn.knn(src.fpfh, tgt.fpfh, tgt.valid, k=1)[0][:, 0]
    ok = src.valid & tgt.valid[idx]
    dst = tgt.points[idx]
    samples = []
    for r in range(params.ransapc_rounds):
        samples.append(T(np.asarray(jransac._sample_indices(keys[r], ok, 1, 8)[0])))
        ok = jransac.ransapc_filter(keys[r], src.points, dst, ok, tolerance=params.voxel_size * 3.0)
    samples.append(T(np.asarray(jransac._sample_indices(keys[-1], ok, params.num_hypotheses,
                                                         params.sample_size))))
    return samples


def test_register_matches_jax_with_fed_samples(features):
    feats, pj, pt, Tg = features
    fs, ft = feats["src"][0], feats["tgt"][0]
    rj = jgr.register(fs, ft, pj)
    samples = jax_register_samples(fs, ft, pj)
    rt = tgr.register(_jax_features_as_torch(fs), _jax_features_as_torch(ft), pt, samples=samples)
    assert bool(rt.success) == bool(rj.success) is True
    assert int(rt.num_inliers) == int(rj.num_inliers)
    np.testing.assert_allclose(N(rt.T), np.asarray(rj.T), atol=1e-3)
    # the port's own draw (generator seeded 0) also finds the motion
    own = tgr.register(feats["src"][1], feats["tgt"][1], pt)
    assert bool(own.success)
    np.testing.assert_allclose(N(own.T), Tg, atol=0.05)


# ---- pose graph -----------------------------------------------------------

def test_pose_graph_matches_jax_with_repeated_edges():
    rng = np.random.default_rng(12)
    xi_gt = (rng.normal(size=(5, 6)) * 0.3).astype(np.float32)
    xi_gt[0] = 0
    gt = np.asarray(jse3.se3_exp(jnp.asarray(xi_gt)))
    noise = (rng.normal(size=(5, 6)) * 0.02).astype(np.float32)
    noise[0] = 0
    poses0 = np.einsum("nij,njk->nik", np.asarray(jse3.se3_exp(jnp.asarray(noise))), gt).astype(np.float32)
    # repeated (src, dst) pairs and poses shared by many edges
    pairs = [(1, 0), (2, 1), (2, 1), (3, 2), (4, 3), (4, 0), (3, 1), (4, 0)]
    edge_list = []
    for s, d in pairs:
        c = rng.integers(40, 90)
        p = rng.normal(size=(c, 3)).astype(np.float32)
        Tsd = np.linalg.inv(gt[d]) @ gt[s]
        q = (p @ Tsd[:3, :3].T + Tsd[:3, 3] + rng.normal(size=p.shape) * 0.002).astype(np.float32)
        edge_list.append({"src": s, "dst": d, "p_src": p, "p_dst": q})
    ej = jpg.build_edges(edge_list, corr_capacity=64)
    et = tpg.build_edges(edge_list, corr_capacity=64)
    for a, b in zip(et, ej):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    oj, cj = jpg.optimize_pose_graph(jnp.asarray(poses0), ej, iters=5)
    ot, ct = tpg.optimize_pose_graph(T(poses0), et, iters=5)
    np.testing.assert_allclose(N(ot), np.asarray(oj), atol=1e-5)
    assert abs(float(ct) - float(cj)) <= 1e-5 * max(1.0, float(cj))
    assert np.abs(N(ot)[:, :3, 3] - gt[:, :3, 3]).max() < np.abs(poses0[:, :3, 3] - gt[:, :3, 3]).max()
    np.testing.assert_array_equal(N(ot)[0], poses0[0])  # gauge: pose 0 fixed


@pytest.mark.parametrize("num_edges_cap", [16, 6])
def test_pose_graph_padded_as_fbaslam_pads_matches_jax(num_edges_cap):
    """`build_edges(num_edges_cap=)`: edges padded to the cap (16) or cut to
    it (6), with the poses padded by identities to a power of two, as the
    JAX package's host-loop FBASlam pads them."""
    rng = np.random.default_rng(13)
    xi_gt = (rng.normal(size=(5, 6)) * 0.3).astype(np.float32)
    xi_gt[0] = 0
    gt = np.asarray(jse3.se3_exp(jnp.asarray(xi_gt)))
    poses0 = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    poses0[:5] = np.einsum("nij,njk->nik", np.asarray(jse3.se3_exp(jnp.asarray(
        np.concatenate([np.zeros((1, 6)), rng.normal(size=(4, 6)) * 0.02]).astype(np.float32)))), gt)
    edge_list = []
    for s, d in [(1, 0), (2, 1), (3, 2), (4, 3), (4, 0), (3, 1), (2, 0), (4, 2)]:
        p = rng.normal(size=(int(rng.integers(40, 90)), 3)).astype(np.float32)
        Tsd = np.linalg.inv(gt[d]) @ gt[s]
        q = (p @ Tsd[:3, :3].T + Tsd[:3, 3] + rng.normal(size=p.shape) * 0.002).astype(np.float32)
        edge_list.append({"src": s, "dst": d, "p_src": p, "p_dst": q})
    ej = jpg.build_edges(edge_list, corr_capacity=64, num_edges_cap=num_edges_cap)
    et = tpg.build_edges(edge_list, corr_capacity=64, num_edges_cap=num_edges_cap)
    assert et.src.shape == (num_edges_cap,) and int(et.edge_valid.sum()) == min(8, num_edges_cap)
    for a, b in zip(et, ej):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    oj, cj = jpg.optimize_pose_graph(jnp.asarray(poses0), ej, iters=5)
    ot, ct = tpg.optimize_pose_graph(T(poses0), et, iters=5)
    np.testing.assert_allclose(N(ot), np.asarray(oj), atol=1e-5)
    assert abs(float(ct) - float(cj)) <= 1e-5 * max(1.0, float(cj))
    np.testing.assert_array_equal(N(ot)[5:], poses0[5:])  # the padding poses stay identities
