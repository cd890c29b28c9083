"""The port's tool CLIs of the real-input slice against the JAX package's, on
the CPU (`--device cpu`: the kernels' plain versions).

- `torch_icp_test --synthetic`, point and plane: T within 2e-4 of the JAX
  tool's on the same seeded pair (ROADMAP queue 3's ICP tolerance; the JAX
  tool's ICP result is recorded from its own run).
- `torch_ba_test`: `full` (the 2-D model) ends within 10 % of the JAX
  tool's final reprojection error; `posegraph` recovers the poses to 1e-5
  as the JAX tool does.
- `torch_transfer_labels`: labels (colours) equal to the JAX tool's.
- `torch_convert_tsdf`: npz -> cube byte-equal to the JAX tool's cube, cube
  -> npz keeps every observed voxel bit for bit, cube -> PLY meshes.
- `torch_convert_to_pcd` on an 80x60 folder: the JAX tool's cloud, points
  within 1e-5 (voxel averages summed in another order), colours within 1e-6.
- `torch_acquire_live_data` on that folder keeps the sensor clock, fuses
  every frame and re-records them (depth x 5000 as 16 bits, as the JAX
  tool writes it).
- `torch_long_run` at 6 frames and 80x60 exits 0 and writes its files.
- Where `jax` and `onepiece_tpu` cannot be imported, every new tool and the
  ring import and `torch_icp_test --synthetic` runs (the import hook of
  `tests/test_torch_tum.py`).

Torch is pinned to one intra-op thread while the module runs.
"""

import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from onepiece_tpu.integration import volume_ops as jvops
from onepiece_tpu.optimization import bundle as jbundle
from onepiece_tpu.optimization import posegraph as jposegraph
from onepiece_tpu.registration import icp as jicp
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.integration import volume_ops
from onepiece_tpu_torch.integration.blocks import TSDFVolume
from onepiece_tpu_torch.io import png, tum
from onepiece_tpu_torch.io.ply import read_ply, write_ply_pointcloud
from onepiece_tpu_torch.utils import synthetic

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"
sys.path.insert(0, str(TOOLS))

import torch_acquire_live_data  # noqa: E402
import torch_ba_test  # noqa: E402
import torch_convert_to_pcd  # noqa: E402
import torch_convert_tsdf  # noqa: E402
import torch_icp_test  # noqa: E402
import torch_long_run  # noqa: E402
import torch_transfer_labels  # noqa: E402

CAM80 = TUM_CAMERA.pyramid(4)[3]
NEW_TOOLS = ("torch_acquire_live_data", "torch_ba_test", "torch_convert_to_pcd", "torch_convert_tsdf",
             "torch_icp_test", "torch_long_run", "torch_transfer_labels", "compare_torch_ring")


_NO_JAX = (
    "import sys, importlib.abc\n"
    "class NoJax(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'onepiece_tpu'):\n"
    "            raise ImportError(name + ' is blocked')\n"
    "sys.meta_path.insert(0, NoJax())\n"
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A 4-frame 80x60 TUM folder written by the port."""
    root = str(tmp_path_factory.mktemp("tum"))
    tum.write_synthetic_tum(root, num_frames=4, camera=CAM80, device="cpu")
    return root


def run_jax_tool(monkeypatch, tool: str, argv: list, module=None, name: str = "") -> object:
    """Run tools/<tool>.py of the JAX package as its CLI; with `module`,
    return the last result of `module.<name>` the run called."""
    got = []
    if module is not None:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: got.append(fn(*a, **k)) or got[-1])
    monkeypatch.setattr(sys, "argv", [f"{tool}.py", *argv])
    runpy.run_path(str(TOOLS / f"{tool}.py"), run_name="__main__")
    return got[-1] if got else None


@pytest.mark.parametrize("mode", ["point", "plane"])
def test_icp_tool_matches_jax(monkeypatch, mode):
    name = "point_to_point" if mode == "point" else "point_to_plane"
    res = run_jax_tool(monkeypatch, "icp_test", ["--synthetic", "--mode", mode], jicp, name)
    out = torch_icp_test.main(["--synthetic", "--mode", mode, "--device", "cpu"])
    assert np.abs(out["T"] - np.asarray(res.T)).max() <= 2e-4
    assert out["inliers"] == int(res.num_inliers) == 3000 and out["max_err"] <= 1e-5


def test_ba_tool_matches_jax(monkeypatch):
    _, mse = run_jax_tool(monkeypatch, "ba_test", ["--mode", "full"], jbundle, "optimize")
    out = torch_ba_test.main(["--mode", "full", "--device", "cpu"])
    assert abs(out["rms_px"] - np.sqrt(mse)) <= 0.1 * np.sqrt(mse)
    assert out["rms_px"] < 2 * 0.5 and np.isfinite(out["pose_err"])
    opt, _ = run_jax_tool(monkeypatch, "ba_test", ["--mode", "posegraph"], jposegraph, "optimize_pose_graph")
    out = torch_ba_test.main(["--mode", "posegraph", "--device", "cpu"])
    T_wc, _ = torch_ba_test.scene(8, 200, np.random.default_rng(0))
    assert np.abs(np.asarray(opt) - T_wc).max() <= 1e-5 and out["pose_err"] <= 1e-5


def test_transfer_labels_tool_matches_jax(monkeypatch, tmp_path):
    rng = np.random.default_rng(4)
    src = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    labels = rng.integers(0, 6, 700)
    write_ply_pointcloud(str(tmp_path / "labeled.ply"), src, colors=(np.eye(6)[labels][:, :3]).astype(np.float32))
    write_ply_pointcloud(str(tmp_path / "target.ply"), rng.uniform(-1.2, 1.2, (900, 3)).astype(np.float32))
    args = [str(tmp_path / "labeled.ply"), str(tmp_path / "target.ply")]
    run_jax_tool(monkeypatch, "transfer_labels", [*args, str(tmp_path / "jax.ply")])
    out = torch_transfer_labels.main([*args, str(tmp_path / "port.ply"), "--device", "cpu"])
    ours, theirs = read_ply(str(tmp_path / "port.ply")), read_ply(str(tmp_path / "jax.ply"))
    assert np.array_equal(ours["vertices"], theirs["vertices"]) and np.array_equal(ours["colors"], theirs["colors"])
    assert 0 < out["labeled"] < out["points"] == 900


def test_convert_tsdf_tool_round_trips(monkeypatch, tmp_path):
    scene = synthetic.default_scene()
    vol = TSDFVolume(voxel_size=0.04, truncation=0.2, capacity=64, device="cpu")
    T = synthetic.orbit_trajectory(2)[0]
    d, g = synthetic.render(scene, torch.from_numpy(T), CAM80.fx, CAM80.fy, CAM80.cx, CAM80.cy, CAM80.height,
                            CAM80.width, num_steps=64)
    vol.integrate(d, g[..., None].expand(-1, -1, 3), T, CAM80)
    npz, cube, back, ply = (str(tmp_path / n) for n in ("v.npz", "v.cube", "back.npz", "v.ply"))
    volume_ops.save_volume(vol, npz)
    torch_convert_tsdf.main([npz, cube, "--device", "cpu"])
    run_jax_tool(monkeypatch, "convert_tsdf", [npz, str(tmp_path / "jax.cube")])
    assert Path(cube).read_bytes() == (tmp_path / "jax.cube").read_bytes()
    torch_convert_tsdf.main([cube, back, "--voxel", "0.04", "--truncation", "0.2", "--device", "cpu"])
    again = volume_ops.load_volume(back, device="cpu")
    n = vol.num_active
    assert again.num_active == n and np.array_equal(again.block_coords[:n], vol.block_coords[:n])
    kept = (vol.sdf[:n].abs() < 1) & (vol.weight[:n] != 0)
    assert int(kept.sum()) > 1000
    for field in ("sdf", "weight", "color"):
        assert torch.equal(getattr(again, field)[:n][kept], getattr(vol, field)[:n][kept])
    assert jvops.load_volume(back).num_active == n
    torch_convert_tsdf.main([cube, ply, "--voxel", "0.04", "--truncation", "0.2", "--device", "cpu"])
    mesh = read_ply(ply)
    assert len(mesh["faces"]) > 1000 and len(mesh["vertices"]) > 500


def test_convert_to_pcd_tool_matches_jax(monkeypatch, folder, tmp_path):
    argv = ["--dataset", folder, "--scale", "8", "--stride", "2"]
    run_jax_tool(monkeypatch, "convert_to_pcd", [*argv, "--out", str(tmp_path / "jax.ply")])
    out = torch_convert_to_pcd.main([*argv, "--out", str(tmp_path / "port.ply"), "--device", "cpu"])
    ours, theirs = read_ply(str(tmp_path / "port.ply")), read_ply(str(tmp_path / "jax.ply"))
    assert out["clouds"] == 2 and len(ours["vertices"]) == len(theirs["vertices"]) == out["points"] > 500
    np.testing.assert_allclose(ours["vertices"], theirs["vertices"], atol=1e-5)
    np.testing.assert_allclose(ours["colors"], theirs["colors"], atol=1e-6)


def test_acquire_live_data_tool_keeps_the_clock(folder, tmp_path):
    rec = tmp_path / "rec"
    out = torch_acquire_live_data.main(["--replay", folder, "--rate", "30", "--frames", "4", "--chunk", "3",
                                        "--scale", "8", "--device", "cpu", "--out", str(rec)])
    assert out["frames"] == 4 and out["seconds"] >= 3 / 30 and out["blocks"] > 0
    assert out["poses"].shape == (4, 4, 4) and np.isfinite(out["poses"]).all()
    seq = tum.TumSequence(folder)
    for i in range(4):
        ts, rgb, depth = seq[i]
        assert np.array_equal(png.read_png(str(rec / "rgb" / f"{ts:.6f}.png")), rgb)
        assert np.array_equal(png.read_png(str(rec / "depth" / f"{ts:.6f}.png")), (depth * 5000.0).astype(np.uint16))


def test_long_run_tool_at_80x60(tmp_path):
    out, metrics = str(tmp_path / "long.json"), str(tmp_path / "long.jsonl")
    summary = torch_long_run.main(["--frames", "6", "--chunk", "3", "--scale", "8", "--device", "cpu",
                                   "--out", out, "--metrics", metrics])
    assert summary["fused"]["block_overflow"] == 0 and summary["sparse_fba"]["edge_overflow"] == 0
    assert Path(out).exists() and len(Path(metrics).read_text().splitlines()) == 4


def test_new_tools_import_no_jax(folder, tmp_path):
    code = "import runpy\n" + "".join(
        f"runpy.run_path({str(TOOLS / (t + '.py'))!r}, run_name='imported')\n" for t in NEW_TOOLS
    ) + (
        f"sys.argv = ['torch_icp_test.py', '--synthetic', '--device', 'cpu', '--iters', '5']\n"
        f"runpy.run_path({str(TOOLS / 'torch_icp_test.py')!r}, run_name='__main__')\n"
        "from onepiece_tpu_torch.io import tum\n"
        f"assert len(list(tum.TumSequence({folder!r}).stream())) == 4\n"
        "assert 'jax' not in sys.modules and 'onepiece_tpu' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", _NO_JAX + code], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert "max |T - T_gt|" in res.stdout
