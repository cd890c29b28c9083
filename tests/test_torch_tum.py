"""The port's TUM reader and writer (`onepiece_tpu_torch/io/tum.py`) against
the JAX package's (`onepiece_tpu/io/tum.py`), and the port's dataset CLIs
where JAX cannot be imported.

- JAX writes, port reads: the JAX package's `write_synthetic_tum` writes an
  80x60 folder of 3 frames (OpenCV's PNG encoder), plain and with the
  sensor model (`corrupt=True`). The port's `TumSequence[i]` equals the
  JAX one's (rgb equal, depth bit-equal), its `stream(gray=True)` is
  bit-equal to the JAX package's native loader's stream (and to the integer
  luma fold computed here from the rgb of each frame decoded alone), and
  `groundtruth()` matches.
- Port writes, JAX reads: the JAX package's `TumSequence` reads the port's
  folder back bit-equal to the port's own `quantize_rgbd` of the same
  render.
- `associate` equals the JAX package's on jittered timestamps with dropped
  frames; an `associate.txt` listing and `max_frames` read the same pairs.
- `tools/torch_dense_odometry.py` and `tools/torch_image_sequence_integration.py`
  run in a subprocess on a 4-frame 80x60 folder with `--device cpu`, where
  `jax` and `onepiece_tpu` cannot be imported: exit 0, a finite ATE (0 at
  the ground-truth poses the integration uses), their outputs written, and
  neither package in `sys.modules`.

Torch is pinned to one intra-op thread while the module runs.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.io import tum as jtum
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.io import tum
from onepiece_tpu_torch.utils import synthetic

REPO = Path(__file__).resolve().parent.parent
CAM80, JCAM80 = TUM_CAMERA.pyramid(4)[3], JCAM.pyramid(4)[3]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_folders(tmp_path_factory):
    """3-frame 80x60 folders written by the JAX package: plain and corrupted."""
    out = {}
    for corrupt in (False, True):
        root = str(tmp_path_factory.mktemp("corrupt" if corrupt else "plain"))
        jtum.write_synthetic_tum(root, num_frames=3, camera=JCAM80, corrupt=corrupt)
        out[corrupt] = root
    return out


@pytest.fixture(scope="module")
def port_folder(tmp_path_factory):
    """A 4-frame 80x60 folder written by the port (CPU render)."""
    root = str(tmp_path_factory.mktemp("port"))
    poses = tum.write_synthetic_tum(root, num_frames=4, camera=CAM80, device="cpu")
    return root, poses


@pytest.mark.parametrize("corrupt", [False, True])
def test_port_reads_jax_folders(jax_folders, corrupt):
    root = jax_folders[corrupt]
    ours, theirs = tum.TumSequence(root), jtum.TumSequence(root)
    assert ours.pairs == theirs.pairs and len(ours) == 3
    for i in range(3):
        (ts, rgb, depth), (jts, jrgb, jdepth) = ours[i], theirs[i]
        assert ts == jts and rgb.dtype == jrgb.dtype == np.uint8
        assert np.array_equal(rgb, jrgb) and depth.dtype == np.float32 and np.array_equal(depth, jdepth)
    loader = theirs.stream(gray=True)
    native = loader._native is not None
    for i, ((d, g), (jd, jg)) in enumerate(zip(ours.stream(gray=True), loader)):
        assert np.array_equal(d, jd) and g.dtype == jg.dtype == np.float32
        if native:
            assert np.array_equal(g, jg)
        c = ours[i][1].astype(np.int64)  # the native loader's integer luma fold
        fold = ((299 * c[..., 0] + 587 * c[..., 1] + 114 * c[..., 2]) // 1000).astype(np.uint8)
        assert np.array_equal(g, fold.astype(np.float32) / 255.0)
    (ts, poses), (jts, jposes) = ours.groundtruth(), theirs.groundtruth()
    assert np.array_equal(ts, jts) and np.array_equal(poses, jposes)


def test_jax_reads_the_port_folder(port_folder):
    root, poses = port_folder
    scene = synthetic.default_scene()
    seq = jtum.TumSequence(root)
    assert len(seq) == 4
    stream = seq.stream(gray=True)
    for i, (d, g) in enumerate(stream):
        depth, gray = synthetic.render(scene, torch.from_numpy(poses[i]), CAM80.fx, CAM80.fy, CAM80.cx, CAM80.cy,
                                       CAM80.height, CAM80.width, num_steps=64)
        qg, qd = synthetic.quantize_rgbd(gray.numpy(), depth.numpy())
        assert np.array_equal(g, qg) and np.array_equal(d, qd)
        _, rgb, depth_m = seq[i]
        assert np.array_equal(rgb, np.repeat(np.round(qg * 255).astype(np.uint8)[..., None], 3, -1))
        assert np.array_equal(depth_m, qd)
    assert np.allclose(seq.groundtruth()[1], poses, atol=2e-6)


def test_associate_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    t = np.arange(40) / 30.0
    rgb = [(float(x), f"rgb/{i}.png") for i, x in enumerate(t + rng.uniform(-0.004, 0.004, 40)) if i % 7 != 3]
    depth = [(float(x), f"depth/{i}.png") for i, x in enumerate(t + rng.uniform(-0.015, 0.015, 40)) if i % 5 != 1]
    pairs = tum.associate(rgb, depth)
    assert pairs == jtum.associate(rgb, depth) and 20 < len(pairs) < 34
    with open(tmp_path / "associate.txt", "w") as f:
        f.write("".join(f"{a:.6f} {ra} {a:.6f} {rd}\n" for a, ra, rd in pairs))
    for max_frames in (None, 5):
        ours = tum.TumSequence(str(tmp_path), max_frames=max_frames).pairs
        assert ours == jtum.TumSequence(str(tmp_path), max_frames=max_frames).pairs
        assert len(ours) == (max_frames or len(pairs))


_NO_JAX = (
    "import sys, importlib.abc\n"
    "class NoJax(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'onepiece_tpu'):\n"
    "            raise ImportError(name + ' is blocked')\n"
    "sys.meta_path.insert(0, NoJax())\n"
)


def _run_without_jax(code: str, cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", _NO_JAX + code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240)


def test_dataset_clis_without_jax(port_folder, tmp_path):
    """Both CLIs in one process (torch imported once), one after the other."""
    root, _ = port_folder
    runs = [("torch_dense_odometry", ["--out", str(tmp_path / "traj.txt")]),
            ("torch_image_sequence_integration", ["--out-mesh", str(tmp_path / "mesh.ply")])]
    code = "import runpy\n" + "".join(
        f"sys.argv = {[f'tools/{tool}.py', '--dataset', root, '--scale', '8', '--device', 'cpu', *out]!r}\n"
        f"runpy.run_path({str(REPO / 'tools' / (tool + '.py'))!r}, run_name='__main__')\n"
        for tool, out in runs
    ) + "assert 'jax' not in sys.modules and 'onepiece_tpu' not in sys.modules\n"
    res = _run_without_jax(code, tmp_path)
    assert res.returncode == 0, res.stderr
    odometry, integration = res.stdout.split("integrated ")
    ates = [float(part.split("ATE RMSE (first 4 frames): ")[1].split()[0]) for part in (odometry, integration)]
    assert np.isfinite(ates).all(), res.stdout
    assert np.loadtxt(tmp_path / "traj.txt").shape == (4, 16)
    # the integration runs at the ground-truth poses themselves
    assert ates[1] == 0.0 and "mesh:" in integration and (tmp_path / "mesh.ply").stat().st_size > 10000
