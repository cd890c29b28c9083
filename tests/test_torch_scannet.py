"""Parity of the port's ScanNet reader (`onepiece_tpu_torch/io/scannet.py`)
and its two CLIs with the JAX package's, on a small ScanNet export made
here: 80x60 depth and 162x121 colour (ScanNet's scene0000_00 intrinsics
over 8), five frames of the synthetic orbit, colour written by cv2 (JPEG
quality 90, 4:2:0), depth as 16-bit PGM in millimetres. Frame 2's pose is
-inf (ScanNet's mark of a lost frame), frame 3 has no colour file and
frame 4's colour is a gray JPEG.

- `read_info`, `camera_from_info`: equal. `ScanNetSequence` items: colour
  bit-equal (or both None), depth and pose bit-equal, -inf included.
- `align_color_to_depth`: bit-equal to JAX's cv2.remap, at the export's
  cameras and at ScanNet's full ones.
- `scannet_to_tum`: the three listings byte-equal, the PNGs pixel-equal
  (read back by cv2); a non-finite pose raises the port's `ValueError`
  naming the frame, where the JAX converter fails inside scipy.
- `read_instance_info`: equal on `tests/test_parity_extras.py`'s case.
- `tools/torch_scannet_model.py` (device cpu, the plain versions) against
  JAX's `tools/scannet_model.py` run in-process, by the meshing tests'
  rule for `TSDFVolume.integrate` against JAX's: block maps equal, weights
  equal, sdf within 5e-4 and colour within 5e-3, at most 1e-4 of the
  voxels outside those bands; the triangle soups then hold the same rows in
  the same order, within 1e-4 m bar 0.5 % of them, and the PLYs' vertex and
  face counts are within 0.5 %.
- Both CLIs run in a subprocess where jax cannot be imported.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from onepiece_tpu.integration import blocks as jblocks
from onepiece_tpu.io import scannet as jscannet
from onepiece_tpu_torch.geometry.camera import PinholeCamera
from onepiece_tpu_torch.io import ply as tply
from onepiece_tpu_torch.io import scannet as tscannet
from onepiece_tpu_torch.utils import synthetic

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import torch_make_scannet_fixture as fixture_tool  # noqa: E402
import torch_scannet_model  # noqa: E402

FRAMES = 5
LOST, NO_COLOUR, GRAY = 2, 3, 4
DEPTH_CAM = PinholeCamera(fx=571.623718 / 8, fy=571.623718 / 8, cx=39.5, cy=29.5, width=80, height=60,
                          depth_scale=1000.0)
COLOR_CAM = PinholeCamera(fx=1170.187988 / 8, fy=1170.187988 / 8, cx=(647.75 + 0.5) / 8 - 0.5,
                          cy=(483.75 + 0.5) / 8 - 0.5, width=162, height=121, depth_scale=1000.0)
VOXEL = 0.04


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _render(pose, cam):
    d, g = synthetic.render(synthetic.default_scene(), torch.from_numpy(pose), cam.fx, cam.fy, cam.cx, cam.cy,
                            cam.height, cam.width, num_steps=48)
    return d.numpy(), g.numpy()


def _jpeg(img: np.ndarray) -> bytes:
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
    assert ok
    return enc.tobytes()


def _export(root: Path, lost=(), no_colour=None, gray=None) -> str:
    poses = synthetic.orbit_trajectory(FRAMES)
    depths, jpegs = [], []
    for i, pose in enumerate(poses):
        depth = _render(pose, DEPTH_CAM)[0]
        depth[0, 0] = 1.027  # 1027 mm: the converter's float32 x 5000 truncates it to 5134, not 5135
        depths.append(depth)
        colour = fixture_tool.tint(_render(pose, COLOR_CAM)[1].astype(np.float64))[..., ::-1]
        jpegs.append(None if i == no_colour else _jpeg(colour[..., 1] if i == gray else colour))
    fixture_tool.write_export(str(root), np.stack(depths), poses, COLOR_CAM, DEPTH_CAM, jpegs, untracked=lost)
    return str(root)


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    return _export(tmp_path_factory.mktemp("scannet"), lost=(LOST,), no_colour=NO_COLOUR, gray=GRAY)


@pytest.fixture(scope="module")
def finite_export(tmp_path_factory):
    return _export(tmp_path_factory.mktemp("scannet_finite"))


def test_read_info_and_cameras_match_jax(export):
    info = tscannet.read_info(os.path.join(export, "_info.txt"))
    assert info == jscannet.read_info(os.path.join(export, "_info.txt"))
    for depth in (True, False):
        c, j = tscannet.camera_from_info(info, depth), jscannet.camera_from_info(info, depth)
        for k in ("fx", "fy", "cx", "cy", "width", "height", "depth_scale"):
            assert getattr(c, k) == getattr(j, k)
        assert c.depth_scale == float(info["m_depthShift"]) == 1000.0


@pytest.mark.parametrize("i", range(FRAMES))
def test_sequence_items_match_jax(export, i):
    ts, js = tscannet.ScanNetSequence(export), jscannet.ScanNetSequence(export)
    assert len(ts) == len(js) == FRAMES
    (ti, trgb, tdepth, tpose), (ji, jrgb, jdepth, jpose) = ts[i], js[i]
    assert ti == ji == i
    if i == NO_COLOUR:
        assert trgb is None and jrgb is None
    else:
        assert trgb.shape == (60, 80, 3) and trgb.dtype == np.uint8
        np.testing.assert_array_equal(trgb, jrgb)
    assert tdepth.dtype == jdepth.dtype == np.float32
    np.testing.assert_array_equal(tdepth, jdepth)
    assert tpose.dtype == np.float64
    np.testing.assert_array_equal(tpose, jpose)
    assert np.isinf(tpose).all() == (i == LOST)


@pytest.mark.parametrize("cameras", ["export", "scannet"])
def test_align_matches_jax(cameras):
    if cameras == "export":
        color_cam, depth_cam = COLOR_CAM, DEPTH_CAM
    else:
        color_cam, depth_cam = fixture_tool.COLOR_CAMERA, fixture_tool.DEPTH_CAMERA
    rgb = np.random.default_rng(6).integers(0, 256, (color_cam.height, color_cam.width, 3), dtype=np.uint8)
    out = tscannet.align_color_to_depth(rgb, color_cam, depth_cam)
    assert out.shape == (depth_cam.height, depth_cam.width, 3)
    np.testing.assert_array_equal(out, jscannet.align_color_to_depth(rgb, color_cam, depth_cam))


def test_scannet_to_tum_matches_jax(finite_export, tmp_path):
    tscannet.scannet_to_tum(finite_export, str(tmp_path / "port"))
    jscannet.scannet_to_tum(finite_export, str(tmp_path / "jax"))
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for sub in ("rgb", "depth"):
        files = sorted(os.listdir(tmp_path / "jax" / sub))
        assert files == sorted(os.listdir(tmp_path / "port" / sub)) and len(files) == FRAMES
        for f in files:
            a = cv2.imread(str(tmp_path / "port" / sub / f), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(tmp_path / "jax" / sub / f), cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            if sub == "depth":
                assert a[0, 0] == 5134  # 1027 mm
    # the quaternion of each line is scipy's, the translation the pose's
    lines = (tmp_path / "port" / "groundtruth.txt").read_text().splitlines()[1:]
    poses = synthetic.orbit_trajectory(FRAMES)
    for line, pose in zip(lines, poses):
        t, q = np.array(line.split()[1:4], float), np.array(line.split()[4:], float)
        assert np.abs(t - pose[:3, 3]).max() <= 1e-6
        from scipy.spatial.transform import Rotation

        assert np.abs(q - Rotation.from_matrix(pose[:3, :3].astype(np.float64)).as_quat()).max() <= 1e-6


def test_scannet_to_tum_stops_at_a_non_finite_pose(export, tmp_path):
    with pytest.raises(ValueError, match=f"frame-{LOST:06d}.pose.txt: the pose is not finite"):
        tscannet.scannet_to_tum(export, str(tmp_path / "port"))
    # the JAX converter fails inside scipy (ROADMAP, faults of the JAX reference)
    with pytest.raises(Exception):
        jscannet.scannet_to_tum(export, str(tmp_path / "jax"))


def test_read_instance_info_matches_jax(tmp_path):
    scene = tmp_path / "scene0000_00"
    os.makedirs(scene)
    segs = {"segIndices": [10, 10, 20, 30, 40]}
    agg = {"segGroups": [{"label": "chair", "segments": [10, 30]}, {"label": "table", "segments": [20]}]}
    (scene / "scene0000_00_vh_clean.segs.json").write_text(json.dumps(segs))
    (scene / "scene0000_00_vh_clean.aggregation.json").write_text(json.dumps(agg))
    p2o, names = tscannet.read_instance_info(str(scene))
    jp2o, jnames = jscannet.read_instance_info(str(scene))
    assert p2o.dtype == jp2o.dtype == np.int32
    np.testing.assert_array_equal(p2o, jp2o)
    np.testing.assert_array_equal(p2o, [0, 0, 1, 0, -1])
    assert names == jnames == ["chair", "table"]


def _jax_scannet_model(argv: list, monkeypatch):
    """tools/scannet_model.py's main() in this process; returns its volume."""
    made = []

    class Recording(jblocks.TSDFVolume):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(jblocks, "TSDFVolume", Recording)
    spec = importlib.util.spec_from_file_location("jax_scannet_model", REPO / "tools" / "scannet_model.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["scannet_model.py", *argv])
    tool.main()
    return made[0]


def test_scannet_model_matches_jax(export, tmp_path, monkeypatch, capsys):
    jvol = _jax_scannet_model([export, str(tmp_path / "jax.ply"), "--voxel", str(VOXEL), "--stride", "1"],
                              monkeypatch)
    assert torch_scannet_model.main([export, str(tmp_path / "port.ply"), "--voxel", str(VOXEL), "--stride", "1",
                                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"integrated {FRAMES - 1} frames" in out
    vol, used = torch_scannet_model.reconstruct(export, VOXEL, 1, device="cpu", log=lambda s: None)
    assert used == FRAMES - 1 and vol.slot_of == jvol.slot_of
    na = vol.num_active
    w = vol.weight[:na].reshape(na, -1).numpy()
    ok = ((w == np.asarray(jvol.weight[:na]).reshape(na, -1))
          & (np.abs(vol.sdf[:na].reshape(na, -1).numpy() - np.asarray(jvol.sdf[:na]).reshape(na, -1)) < 5e-4)
          & (np.abs(vol.color[:na].reshape(na, -1, 3).numpy()
                    - np.asarray(jvol.color[:na]).reshape(na, -1, 3)) < 5e-3).all(-1))
    seen = w > 0
    assert seen.sum() > 10000 and (~ok).sum() <= 1e-4 * seen.sum()
    # the meshes: the same triangles in the same order, each within 1e-4 m
    # bar 0.5 % of them (measured: 3.7e-5 m at most, 0.17 % beyond 1e-5)
    tv, jtv = vol.extract_mesh()[0], np.asarray(jvol.extract_mesh()[0])
    assert tv.shape == jtv.shape and len(tv) > 10000
    assert (np.abs(tv - jtv).max(axis=(1, 2)) > 1e-4).mean() <= 0.005
    # the PLYs: vertex merging rounds positions to a grid, so a vertex may
    # land in the next cell; the counts stay within 0.5 %
    port, jax_mesh = tply.read_ply(str(tmp_path / "port.ply")), tply.read_ply(str(tmp_path / "jax.ply"))
    for key in ("vertices", "faces"):
        assert abs(len(port[key]) - len(jax_mesh[key])) <= 0.005 * len(jax_mesh[key])

def _run_without_jax(argv: list, cwd) -> subprocess.CompletedProcess:
    block = ("import sys\n"
             "class _NoJax:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name == 'jax' or name.startswith(('jax.', 'onepiece_tpu.')) or name == 'onepiece_tpu':\n"
             "            raise ImportError('jax is blocked in this test')\n"
             "sys.meta_path.insert(0, _NoJax())\n"
             "import runpy\n"
             f"sys.argv = {argv!r}\n"
             f"runpy.run_path({argv[0]!r}, run_name='__main__')\n"
             "assert 'jax' not in sys.modules and 'onepiece_tpu' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", block], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=240)


@pytest.mark.parametrize("tool", ["torch_scannet_model", "torch_scannet_to_tum"])
def test_clis_run_without_jax(export, tmp_path, tool):
    script = str(REPO / "tools" / f"{tool}.py")
    if tool == "torch_scannet_model":
        res = _run_without_jax([script, export, str(tmp_path / "m.ply"), "--voxel", str(VOXEL), "--stride", "1",
                                "--device", "cpu"], tmp_path)
        assert res.returncode == 0, res.stderr
        mesh = tply.read_ply(str(tmp_path / "m.ply"))
        assert len(mesh["faces"]) > 1000 and np.isfinite(mesh["vertices"]).all()
        assert f"mesh: {len(mesh['vertices'])} verts" in res.stdout
    else:
        res = _run_without_jax([script, export, str(tmp_path / "tum"), "--max-frames", str(LOST)], tmp_path)
        assert res.returncode == 0, res.stderr
        assert len(os.listdir(tmp_path / "tum" / "rgb")) == LOST
        res = _run_without_jax([script, export, str(tmp_path / "tum2")], tmp_path)
        assert res.returncode != 0 and "the pose is not finite" in res.stderr
