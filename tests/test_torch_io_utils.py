"""The port's file formats and small utilities against the JAX package's.

- `io/ref_tsdf.py`: a volume the port fused (two 80x60 frames, on the CPU)
  is carried to the JAX package through the npz of `volume_ops.save_volume`
  / `load_volume`, which both read; the port's cube file is byte-equal to
  JAX `write_ref_tsdf` of it, its first word is the block count's uint32
  bit pattern, and each package reads the other's file to the same
  {block key -> voxels}. A volume with no block round-trips too.
- `io/obj.py`: files byte-equal to the JAX writer's (with and without
  normals); a file of triangles, quads, pentagons and `v/t/n` faces reads
  equal (fan triangulation).
- `utils/config.py`: a JAX-written JSON (with its TPU-only
  `dense.stencil_radii`) loads into the port with every other value, the
  port's JSON loads into the JAX package equal; unknown keys raise.
- `PointCloud.from_rgbd` with rgb (and without) equals JAX's.
- `utils/logging.py`'s `log` keeps the JAX contract: the component line
  and the verbosity levels.
- `io/openni.py`: `ReplayRGBDReader` delivers frames on its clock and ends
  with None (as `tests/test_misc.py` holds the JAX one); the live reader
  raises.

Torch is pinned to one intra-op thread while the module runs.
"""

import dataclasses
import json
import struct
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry import pointcloud as jpc
from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.integration import volume_ops as jvops
from onepiece_tpu.io import obj as jobj
from onepiece_tpu.io import ref_tsdf as jref
from onepiece_tpu.utils import config as jconfig
from onepiece_tpu.utils import logging as jlogging
from onepiece_tpu_torch.geometry import pointcloud as tpc
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.integration import volume_ops
from onepiece_tpu_torch.integration.blocks import TSDFVolume
from onepiece_tpu_torch.io import obj, png, ref_tsdf
from onepiece_tpu_torch.io.openni import LiveRGBDReader, ReplayRGBDReader
from onepiece_tpu_torch.utils import config, logging, synthetic

CAM80, JCAM80 = TUM_CAMERA.pyramid(4)[3], JCAM.pyramid(4)[3]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fused_volume():
    """The port's TSDFVolume of two 80x60 orbit frames at their poses."""
    poses = synthetic.orbit_trajectory(8)[::4]
    scene = synthetic.default_scene()
    vol = TSDFVolume(voxel_size=0.04, truncation=0.2, capacity=64, device="cpu")
    for i, T in enumerate(poses):
        d, g = synthetic.render(scene, torch.from_numpy(T), CAM80.fx, CAM80.fy, CAM80.cx, CAM80.cy, CAM80.height,
                                CAM80.width, num_steps=64)
        rgb = torch.stack([g, 1.0 - g, torch.full_like(g, i / 2)], -1)  # distinct colour channels
        vol.integrate(d, rgb, T, CAM80)
    assert vol.num_active > 100
    return vol


def blocks(vol) -> dict:
    """{block coords -> (sdf, weight, color) of its voxels} of either package's volume."""
    n = vol.num_active
    sdf, weight, color = (np.asarray(x)[:n] for x in (vol.sdf, vol.weight, vol.color))
    return {tuple(c): (sdf[i], weight[i], color[i]) for i, c in enumerate(np.asarray(vol.block_coords)[:n].tolist())}


def assert_same_blocks(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert np.array_equal(x, y), k


def test_ref_tsdf_matches_jax_byte_for_byte(fused_volume, tmp_path):
    npz, ours, theirs = (str(tmp_path / n) for n in ("v.npz", "port.cube", "jax.cube"))
    volume_ops.save_volume(fused_volume, npz)
    jvol = jvops.load_volume(npz)
    ref_tsdf.write_ref_tsdf(ours, fused_volume)
    jref.write_ref_tsdf(theirs, jvol)
    data = open(ours, "rb").read()
    assert data == open(theirs, "rb").read()
    assert struct.unpack("<I", data[:4])[0] == fused_volume.num_active
    # each package reads the other's file to the same blocks
    back, jback = ref_tsdf.read_ref_tsdf(theirs, 0.04, 0.2, device="cpu"), jref.read_ref_tsdf(ours, 0.04, 0.2)
    assert back.num_active == jback.num_active == fused_volume.num_active
    assert_same_blocks(blocks(back), blocks(jback))
    # the file keeps the observed voxels (|sdf| < 1, weight != 0) exactly
    w = fused_volume.weight[: fused_volume.num_active]
    kept = (fused_volume.sdf[: fused_volume.num_active].abs() < 1) & (w != 0)
    assert 0 < int(kept.sum()) < kept.numel()
    for field in ("sdf", "weight", "color"):
        a, b = getattr(back, field)[: back.num_active], getattr(fused_volume, field)[: back.num_active]
        assert torch.equal(a[kept], b[kept])


def test_ref_tsdf_of_an_empty_volume(tmp_path):
    path = str(tmp_path / "empty.cube")
    ref_tsdf.write_ref_tsdf(path, TSDFVolume(capacity=16, device="cpu"))
    jref.write_ref_tsdf(str(tmp_path / "jax.cube"), jvops.TSDFVolume(capacity=16))
    assert open(path, "rb").read() == open(tmp_path / "jax.cube", "rb").read() == b"\0" * 4
    assert ref_tsdf.read_ref_tsdf(path, device="cpu").num_active == 0


def test_obj_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(9, 3)).astype(np.float32)
    normals = rng.normal(size=(9, 3)).astype(np.float32)
    faces = rng.integers(0, 9, size=(5, 3))
    for n in (None, normals):
        obj.write_obj(str(tmp_path / "port.obj"), verts, faces, n)
        jobj.write_obj(str(tmp_path / "jax.obj"), verts, faces, n)
        assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
        ours, theirs = obj.read_obj(str(tmp_path / "port.obj")), jobj.read_obj(str(tmp_path / "port.obj"))
        assert ours.keys() == theirs.keys() and all(np.array_equal(ours[k], theirs[k]) for k in ours)
        assert np.array_equal(ours["faces"], faces) and np.allclose(ours["vertices"], verts, atol=5e-7)
    poly = tmp_path / "poly.obj"
    poly.write_text("# polygons\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 2 0\nvn 0 0 1\n\n"
                    "f 1 2 3\nf 1/1 2/2 3/3 4/4\nf 1//1 2//1 3//1 4//1 5//1\n")
    ours, theirs = obj.read_obj(str(poly)), jobj.read_obj(str(poly))
    assert ours.keys() == theirs.keys() and all(np.array_equal(ours[k], theirs[k]) for k in ours)
    assert ours["faces"].tolist() == [[0, 1, 2], [0, 1, 2], [0, 2, 3], [0, 1, 2], [0, 2, 3], [0, 3, 4]]


def test_config_json_both_ways(tmp_path):
    jcfg = jconfig.Config()
    jcfg.dense.iters = (9, 5, 2)
    jcfg.icp.point_to_plane = True
    jcfg.slam.submap_size = 17
    jcfg.to_json(str(tmp_path / "jax.json"))
    cfg = config.Config.from_json(str(tmp_path / "jax.json"))
    want = dataclasses.asdict(jcfg)
    del want["dense"]["stencil_radii"]  # the TPU tracker's, not the port's
    assert dataclasses.asdict(cfg) == want
    cfg.to_json(str(tmp_path / "port.json"))
    assert dataclasses.asdict(jconfig.Config.from_json(str(tmp_path / "port.json"))) == dataclasses.asdict(jcfg)
    defaults = dataclasses.asdict(jconfig.Config())
    del defaults["dense"]["stencil_radii"]
    assert dataclasses.asdict(config.Config()) == defaults
    (tmp_path / "bad.json").write_text(json.dumps({"icp": {"iterations": 3}}))
    with pytest.raises(KeyError, match="icp.iterations"):
        config.Config.from_json(str(tmp_path / "bad.json"))


@pytest.mark.parametrize("with_rgb", [False, True])
def test_from_rgbd_with_colour_matches_jax(with_rgb):
    rng = np.random.default_rng(9)
    depth = rng.uniform(0.02, 12.0, size=(60, 80)).astype(np.float32)
    depth[rng.random((60, 80)) < 0.1] = np.nan
    rgb = rng.uniform(0, 1, size=(60, 80, 3)).astype(np.float32) if with_rgb else None
    cj = jpc.PointCloud.from_rgbd(jnp.asarray(depth), None if rgb is None else jnp.asarray(rgb), JCAM80)
    ct = tpc.PointCloud.from_rgbd(torch.from_numpy(depth), None if rgb is None else torch.from_numpy(rgb), CAM80)
    assert np.array_equal(ct.valid.numpy(), np.asarray(cj.valid))
    assert np.array_equal(ct.colors.numpy(), np.asarray(cj.colors))
    v = ct.valid.numpy()
    np.testing.assert_allclose(ct.points.numpy()[v], np.asarray(cj.points)[v], atol=1e-5)


def test_metrics_logger_and_log_contract(capsys, monkeypatch):
    for mod in (logging, jlogging):
        for verbosity in (0, 1, 2):
            monkeypatch.setattr(mod, "VERBOSITY", verbosity)
            mod.log("Ring", "INFO", "started")
            mod.log("Ring", "DEBUG", "slot 3")
    err = capsys.readouterr().err
    assert err.count("[Ring]::[INFO]::started") == 4 and err.count("[Ring]::[DEBUG]::slot 3") == 2


def test_replay_reader_keeps_the_clock_and_ends_with_none(tmp_path):
    root = tmp_path / "seq"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    for i in range(3):
        ts = f"{i * 0.1:.6f}"
        png.write_png(str(root / "rgb" / f"{ts}.png"), np.full((8, 8, 3), i * 40, np.uint8))
        png.write_png(str(root / "depth" / f"{ts}.png"), np.full((8, 8), 5000, np.uint16))
    (root / "rgb.txt").write_text("".join(f"{i * 0.1:.6f} rgb/{i * 0.1:.6f}.png\n" for i in range(3)))
    (root / "depth.txt").write_text("".join(f"{i * 0.1:.6f} depth/{i * 0.1:.6f}.png\n" for i in range(3)))
    r = ReplayRGBDReader(str(root), rate_hz=50.0)
    assert r.get_next_rgbd() is None  # before init
    assert r.init()
    t0 = time.monotonic()
    frames = []
    while (item := r.get_next_rgbd()) is not None:
        frames.append(item)
    assert time.monotonic() - t0 >= 2 / 50.0 - 1e-3
    assert [f[0] for f in frames] == [0.0, 0.1, 0.2]
    assert all(f[1].dtype == np.uint8 and f[1][0, 0, 0] == i * 40 for i, f in enumerate(frames))
    assert all(f[2].dtype == np.float32 and np.all(f[2] == 1.0) for f in frames)
    r.close()
    assert r.get_next_rgbd() is None
    with pytest.raises(NotImplementedError):
        LiveRGBDReader().init()
