"""The port's submap-parallel DenseSlam (`parallel/submap.py`) on the CPU.

Three submaps of 4 frames of the 80x60 orbit (fx = fy = 50), one submap a
rank over 3 gloo processes (`parallel/launch.spawn`). Tolerances, and why:

  - the sharded pipeline against the port's serial one: bit-equal (the
    collectives only move data between the same stage functions, and the
    ranks and this process sum with one intra-op thread each);
  - each stage function against JAX's on the same inputs:
      - `track_one_submap` against JAX's with its tracker set to
        `dense_tracking_exact` (the port's exact gather form; JAX's own
        stage runs the prewarp tracker, ROADMAP queue 3): relative poses
        and the boundary step within 1e-4 (the exact trackers' bar in
        `tests/test_torch_dense_odometry.py`);
      - `chain_base_poses`: 1e-6;
      - `build_submap_geometry` fed JAX's track: the same valid points,
        their coordinates within 1e-6 (voxel averages summed in another
        order), normals within 1e-4 (up to sign) on 99 % of them
        (`tests/test_torch_registration.py`'s bar), the FPFH of JAX's points
        and normals within 1e-3 on 95 % of the rows (measured 96.4 %: the
        voxel averages lie near a regular grid, so many neighbour distances
        tie at the k = 32 cut; the registration test's 99 % is on a random
        cloud);
      - `register_one_submap` fed JAX's clouds and base poses, with JAX's
        RANSAC sample indices fed to the port's `register` (the RNGs
        differ): the same valid edges; the consecutive ICP within 5e-4
        (measured 2.0e-4: over 30 iterations on these sparse clouds a few
        near-tie correspondences differ, nn1's difference form against
        JAX's expansion form; `tests/test_torch_registration.py` holds ICP
        to 1e-4 on denser ones), the loop edge within 1e-3 (register's bar);
      - `solve_pose_graph` fed JAX's edges and clouds: 1e-5;
  - marked slow: the whole pipeline against JAX's `submap_pipeline_sharded`
    (its tracker set to the exact form, as above) on a mesh of 3 virtual
    devices at JAX's own per-stage gates
    (`tests/test_parallel.py::test_submap_parallel_matches_serial`: clouds
    < 1e-3, the same valid edges, final poses within 3 cm).

Torch is pinned to one intra-op thread while the module runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from onepiece_tpu.geometry.camera import PinholeCamera as JCam
from onepiece_tpu.odometry import dense as jdense
from onepiece_tpu.parallel import submap as jsm
from onepiece_tpu.registration import global_reg as jgr
from onepiece_tpu_torch.geometry.camera import PinholeCamera as TCam
from onepiece_tpu_torch.parallel import drive, launch
from onepiece_tpu_torch.parallel import submap as tsm
from onepiece_tpu_torch.registration import fpfh as tfpfh
from onepiece_tpu_torch.registration import global_reg as tgr
from onepiece_tpu_torch.utils import synthetic
from test_torch_registration import jax_register_samples

CAM = dict(fx=50.0, fy=50.0, cx=39.5, cy=29.5, width=80, height=60, depth_scale=1000.0)
S, F = 3, 4
CAPACITY = 2048  # JAX's fixed compaction keeps a submap's first 2,048 voxels by key (in x order), as the port's does
KW = dict(cloud_capacity=CAPACITY)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    cam = TCam(**CAM)
    scene = synthetic.default_scene()
    fr = [synthetic.render(scene, torch.from_numpy(p), cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width,
                           num_steps=64) for p in synthetic.orbit_trajectory(S * F)]
    grays = np.stack([g.numpy() for _, g in fr]).reshape(S, F, cam.height, cam.width)
    depths = np.stack([d.numpy() for d, _ in fr]).reshape(S, F, cam.height, cam.width)
    return grays, depths


@pytest.fixture(scope="module")
def port(frames):
    grays, depths = frames
    cam = TCam(**CAM)
    serial = tsm.submap_pipeline_serial(grays, depths, cam, "cpu", **KW)
    ranks = launch.spawn(S, drive.run_submap, dict(grays=grays, depths=depths, camera=cam, kwargs=KW),
                         backend="gloo", device="cpu", timeout=300)
    return serial, ranks


def test_sharded_pipeline_is_the_serial_one_bit_for_bit(port):
    serial, ranks = port
    for r in ranks:
        out = r["out"]
        for name in ("frame_poses", "base", "base_raw", "rmse"):
            np.testing.assert_array_equal(out[name], getattr(serial, name), err_msg=name)
        for a, b in zip(out["geos"], serial.geos):
            np.testing.assert_array_equal(a, b.numpy())
        for a, b in zip(out["edges"], serial.edges):
            np.testing.assert_array_equal(a, b.numpy())
    assert serial.edges.valid[1:, 0].all()  # the consecutive ICP edges fired
    ranks_nn1 = [r["launches"]["nn1"] for r in ranks]
    assert ranks_nn1 == [0, 0, 0]  # the plain nn1 on the CPU: no kernel launch
    comm = ranks[0]["comm"]
    assert comm["ring_shift"]["calls"] == 1 and comm["all_gather"]["calls"] == 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _exact(src, tgt, camera, iters, radii):
    """JAX's exact gather tracker in the place of its prewarp `dense_tracking`."""
    return jdense.dense_tracking_exact(src, tgt, camera, iters=iters)


def _jtrack(grays, depths, i, cam):
    prev = (grays[i - 1, -1], depths[i - 1, -1]) if i else (grays[0, 0], depths[0, 0])
    return jsm.track_one_submap(jnp.asarray(grays[i]), jnp.asarray(depths[i]), jnp.asarray(prev[0]),
                                jnp.asarray(prev[1]), jnp.bool_(i > 0), cam)


@pytest.fixture(scope="module")
def jax_stages(frames):
    """JAX's stage functions over the frames, its tracker set to the exact
    gather form."""
    grays, depths = frames
    cam = JCam(**CAM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsm.dense, "dense_tracking", _exact)
        tracks = [_jtrack(grays, depths, i, cam) for i in range(S)]
    base = jsm.chain_base_poses(jnp.stack([t.rel[-1] for t in tracks]), jnp.stack([t.step for t in tracks]))
    params = jgr.RansacParams(voxel_size=tsm.VOXEL_SIZE)
    geos = [jsm.build_submap_geometry(jnp.asarray(grays[i]), jnp.asarray(depths[i]), tracks[i], cam,
                                      tsm.VOXEL_SIZE, CAPACITY, params) for i in range(S)]
    all_geo = jax.tree.map(lambda *a: jnp.stack(a), *geos)
    edges = [jsm.register_one_submap(jnp.int32(i), geos[i], geos[max(i - 1, 0)], all_geo, base,
                                     tsm.ICP_THRESHOLD, params, S - 2) for i in range(S)]
    edges = jax.tree.map(lambda *a: jnp.stack(a), *edges)
    opt = jsm.solve_pose_graph(np.asarray(base), edges, all_geo)
    return dict(tracks=tracks, base=base, geos=geos, all_geo=all_geo, edges=edges, opt=opt, params=params)


def _as_port(geo):
    return tsm.SubmapGeometry(*(_t(a) for a in geo))


def test_track_one_submap_matches_jax(frames, jax_stages):
    grays, depths = frames
    cam = TCam(**CAM)
    for i, tj in enumerate(jax_stages["tracks"]):
        prev = (_t(grays[i - 1, -1]), _t(depths[i - 1, -1])) if i else (None, None)
        tt = tsm.track_one_submap(_t(grays[i]), _t(depths[i]), *prev, cam)
        assert np.abs(tt.rel.numpy() - np.asarray(tj.rel)).max() <= 1e-4
        assert np.abs(tt.step.numpy() - np.asarray(tj.step)).max() <= 1e-4


def test_chain_base_poses_matches_jax(jax_stages):
    tracks = jax_stages["tracks"]
    got = tsm.chain_base_poses(_t(np.stack([t.rel[-1] for t in tracks])), _t(np.stack([t.step for t in tracks])))
    assert np.abs(got.numpy() - np.asarray(jax_stages["base"])).max() <= 1e-6


def test_build_submap_geometry_matches_jax(frames, jax_stages):
    _, depths = frames
    cam = TCam(**CAM)
    params = tgr.RansacParams(voxel_size=tsm.VOXEL_SIZE)
    for i, (tj, gj) in enumerate(zip(jax_stages["tracks"], jax_stages["geos"])):
        track = tsm.SubmapTrack(_t(tj.rel), _t(tj.step), _t(tj.rmse))
        gt = tsm.build_submap_geometry(_t(depths[i]), track, cam, tsm.VOXEL_SIZE, CAPACITY, params)
        v = np.asarray(gj.valid)
        np.testing.assert_array_equal(gt.valid.numpy(), v)
        assert v.sum() > 200
        assert np.abs(gt.points.numpy()[v] - np.asarray(gj.points)[v]).max() <= 1e-6
        dots = np.abs(np.sum(gt.normals.numpy()[v] * np.asarray(gj.normals)[v], -1))
        assert (dots >= 1 - 1e-4).mean() >= 0.99
        # the stage's FPFH on JAX's points and normals (its own normals move
        # angles across bin edges: `tests/test_torch_registration.py`)
        feats = tfpfh.compute_fpfh(_t(gj.points), _t(gj.normals), _t(gj.valid), radius=params.fpfh_radius,
                                   k=params.fpfh_k)
        rows = np.abs(feats.numpy()[v] - np.asarray(gj.fpfh)[v]).max(1) <= 1e-3
        assert rows.mean() >= 0.95


def test_register_one_submap_matches_jax(jax_stages, monkeypatch):
    params = tgr.RansacParams(voxel_size=tsm.VOXEL_SIZE)
    register = tgr.register

    def fed(src, tgt, p):  # JAX's sample indices for these (JAX's own) clouds
        js, jt = (jgr.CloudFeatures(*(jnp.asarray(a.numpy()) for a in f)) for f in (src, tgt))
        return register(src, tgt, p, samples=jax_register_samples(js, jt, jax_stages["params"]))

    monkeypatch.setattr(tgr, "register", fed)
    all_geo = _as_port(jax_stages["all_geo"])
    base = _t(jax_stages["base"])
    ej = jax_stages["edges"]
    for i in range(S):
        e = tsm.register_one_submap(i, _as_port(jax_stages["geos"][i]), _as_port(jax_stages["geos"][max(i - 1, 0)]),
                                    all_geo, base, tsm.ICP_THRESHOLD, params, S - 2)
        valid = np.asarray(ej.valid[i])
        np.testing.assert_array_equal(e.valid.numpy(), valid)
        np.testing.assert_array_equal(e.dst.numpy(), np.asarray(ej.dst[i]))
        for slot, tol in ((0, 5e-4), (1, 1e-3)):
            if valid[slot]:
                assert np.abs(e.T.numpy()[slot] - np.asarray(ej.T[i, slot])).max() <= tol, (i, slot)
    assert np.asarray(ej.valid)[1:, 0].all()


def test_solve_pose_graph_matches_jax(jax_stages):
    ej = jax_stages["edges"]
    edges = tsm.SubmapEdges(_t(ej.dst).long(), _t(ej.T), _t(ej.valid))
    got = tsm.solve_pose_graph(np.asarray(jax_stages["base"]), edges, _as_port(jax_stages["all_geo"]), "cpu")
    assert np.abs(got - np.asarray(jax_stages["opt"])).max() <= 1e-5


@pytest.mark.slow
def test_pipeline_matches_jax_sharded_at_its_gates(frames, port):
    grays, depths = frames
    mesh = Mesh(np.array(jax.devices()[:S]), ("d",))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsm.dense, "dense_tracking", _exact)
        fp_j, _, edges_j, geos_j, _ = jsm.submap_pipeline_sharded(grays, depths, JCam(**CAM), mesh,
                                                                  voxel_size=tsm.VOXEL_SIZE, cloud_capacity=CAPACITY)
    out = port[1][0]["out"]
    np.testing.assert_array_equal(out["edges"].valid, np.asarray(edges_j.valid))
    both = out["geos"].valid & np.asarray(geos_j.valid)
    assert both.any() and np.abs(out["geos"].points - np.asarray(geos_j.points))[both].max() < 1e-3
    np.testing.assert_allclose(out["frame_poses"], fp_j, atol=3e-2)
