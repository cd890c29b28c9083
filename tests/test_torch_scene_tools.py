"""The port's scene-analysis and visualisation CLIs on the CPU (`--device
cpu`), at tiny sizes:

- each of `torch_clustering_demo` (three methods), `torch_detect_plane`,
  `torch_room_detection`, `torch_mesh_tools` (five commands),
  `torch_read_ply` (mesh, pcd, rgbd) and `torch_render_turntable` runs and
  writes its outputs; `torch_fused_fusion --turntable` and
  `torch_dense_fusion --turntable` at 80x60 exit 0 and write the views and
  the GIF;
- `torch_detect_plane` and `torch_room_detection` print the same patch,
  wall-line, face and room counts as the JAX package's CLIs on their
  default synthetic inputs;
- where `jax` and `onepiece_tpu` cannot be imported, the six CLIs import
  and `torch_room_detection` runs.

Torch is pinned to one intra-op thread while the module runs.
"""

import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from onepiece_tpu_torch.io import tum
from onepiece_tpu_torch.io.ply import read_ply, write_ply_mesh, write_ply_pointcloud
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from test_mesh import icosphere

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"
sys.path.insert(0, str(TOOLS))

import torch_clustering_demo  # noqa: E402
import torch_detect_plane  # noqa: E402
import torch_mesh_tools  # noqa: E402
import torch_read_ply  # noqa: E402
import torch_render_turntable  # noqa: E402
import torch_room_detection  # noqa: E402

SCENE_TOOLS = ("torch_clustering_demo", "torch_detect_plane", "torch_room_detection", "torch_mesh_tools",
               "torch_read_ply", "torch_render_turntable")
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


@pytest.fixture
def mesh_ply(tmp_path):
    v, f = icosphere(3)
    c = np.random.default_rng(0).uniform(0, 1, v.shape).astype(np.float32)
    path = str(tmp_path / "sphere.ply")
    write_ply_mesh(path, v, f, colors=c)
    return path


@pytest.mark.parametrize("method", ["kmeans", "kmedoids", "meanshift"])
def test_clustering_demo(tmp_path, method, capsys):
    out = str(tmp_path / "c.ply")
    labels = torch_clustering_demo.main(["", out, "--method", method, "--k", "3", "--device", "cpu"])
    assert len(labels) == 900 and labels.min() >= 0
    assert len(read_ply(out)["vertices"]) == 900
    assert f"{method}: " in capsys.readouterr().out


def _counts(text: str) -> dict:
    found = {}
    for key, pattern in (("patches", r"(\d+) plane patches"), ("lines", r"(\d+) wall lines detected"),
                         ("faces", r"arrangement: (\d+) faces"), ("rooms", r"room (\d+): faces")):
        found[key] = [int(x) for x in re.findall(pattern, text)]
    found["rooms"] = len(found["rooms"])
    found["pass"] = "PASS" in text
    return found


@pytest.mark.parametrize("tool", ["detect_plane", "room_detection"])
def test_counts_equal_the_jax_cli(tool, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [f"{tool}.py"])
    runpy.run_path(str(TOOLS / f"{tool}.py"), run_name="__main__")
    jax_out = capsys.readouterr().out
    {"detect_plane": torch_detect_plane, "room_detection": torch_room_detection}[tool].main(["--device", "cpu"])
    port_out = capsys.readouterr().out
    assert _counts(port_out) == _counts(jax_out)
    assert _counts(port_out)["patches" if tool == "detect_plane" else "lines"][0] >= 3


def test_detect_plane_on_a_ply(tmp_path):
    rng = np.random.default_rng(3)
    floor = np.c_[rng.uniform(0, 1, (600, 2)), np.zeros(600)].astype(np.float32)
    path = str(tmp_path / "floor.ply")
    write_ply_pointcloud(path, floor)
    patches = torch_detect_plane.main([path, str(tmp_path / "p.ply"), "--device", "cpu", "--max-points", "500"])
    assert len(patches) == 1 and abs(abs(patches[0].model[2]) - 1) < 1e-6
    assert len(read_ply(str(tmp_path / "p.ply"))["vertices"]) == 500


@pytest.mark.parametrize("cmd", ["simplify-quadric", "simplify-cluster", "prune", "normals", "info"])
def test_mesh_tools(cmd, mesh_ply, tmp_path, capsys):
    out = str(tmp_path / "out.ply")
    torch_mesh_tools.main([cmd, mesh_ply, out, "--target-faces", "300", "--cell-size", "0.3", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "in: 642 verts 1280 faces" in text
    if cmd == "info":
        assert not os.path.exists(out)
        return
    back = read_ply(out)
    n_faces = {"simplify-quadric": (250, 300), "simplify-cluster": (1, 640), "prune": (1280, 1280),
               "normals": (1280, 1280)}[cmd]
    assert n_faces[0] <= len(back["faces"]) <= n_faces[1]
    assert ("normals" in back) == (cmd == "normals")


@pytest.mark.parametrize("cmd", ["mesh", "pcd"])
def test_read_ply_mesh_and_pcd(cmd, mesh_ply, tmp_path, capsys):
    from onepiece_tpu_torch.io.png import read_png

    args = [cmd, mesh_ply, "--rewrite", str(tmp_path / "copy.ply"), "--device", "cpu"]
    if cmd == "mesh":
        args += ["--preview", str(tmp_path / "preview.png")]
    torch_read_ply.main(args)
    text = capsys.readouterr().out
    assert "vertices: 642" in text and "round-trip ok" in text
    if cmd == "mesh":
        assert "faces:    1280" in text and "surface area" in text
        preview = read_png(str(tmp_path / "preview.png"))
        assert preview.shape == (480, 640, 3) and preview.any()


def test_read_ply_rgbd(tmp_path, capsys):
    cam = TUM_CAMERA.pyramid(4)[3]
    tum.write_synthetic_tum(str(tmp_path / "seq"), 1, cam, device="cpu")
    depth = next((tmp_path / "seq" / "depth").glob("*.png"))
    rgb = next((tmp_path / "seq" / "rgb").glob("*.png"))
    torch_read_ply.main(["rgbd", str(depth), "--rgb", str(rgb), "--rewrite", str(tmp_path / "cloud.ply"),
                         "--device", "cpu"])
    text = capsys.readouterr().out
    n = int(re.search(r"backprojected cloud: (\d+) points", text).group(1))
    assert "depth: (60, 80)" in text and "rgb:   (60, 80, 3)" in text and n > 1000
    back = read_ply(str(tmp_path / "cloud.ply"))
    assert len(back["vertices"]) == n and back["colors"] is not None


def test_render_turntable(mesh_ply, tmp_path):
    paths = torch_render_turntable.main([mesh_ply, "--frames", "3", "--width", "80", "--height", "60",
                                         "--out-dir", str(tmp_path / "tt"), "--gif", str(tmp_path / "tt.gif"),
                                         "--arc", "90", "--device", "cpu"])
    assert len(paths) == 3 and all(os.path.exists(p) for p in paths)
    assert (tmp_path / "tt.gif").read_bytes()[:6] == b"GIF89a"


@pytest.mark.parametrize("tool", ["torch_fused_fusion", "torch_dense_fusion"])
def test_fusion_turntable(tool, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, str(TOOLS / f"{tool}.py"), "--synthetic", "4", "--scale", "8", "--device", "cpu",
         "--out-mesh", "m.ply", "--out-traj", "t.txt", "--turntable", "tt"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert len(list((tmp_path / "tt").glob("turntable_*.png"))) == 24
    assert (tmp_path / "tt" / "turntable.gif").exists()


def test_turntable_flag_is_added_once():
    """The JAX package's tools/dense_fusion.py adds --turntable twice (argparse
    raises on it); the port's fusion CLIs take it once."""
    for tool in ("torch_fused_fusion", "torch_dense_fusion"):
        assert (TOOLS / f"{tool}.py").read_text().count("add_turntable_arg(ap)") == 1
    assert (TOOLS / "_torch_common.py").read_text().count('"--turntable"') == 1


def test_scene_tools_run_without_jax(tmp_path):
    code = (
        "import runpy, sys, torch\n"
        f"sys.path.insert(0, {str(TOOLS)!r})\n"
        "torch.set_num_threads(1)\n"
        + "".join(f"import {t}\n" for t in SCENE_TOOLS)
        + "sys.argv = ['torch_room_detection.py', '--device', 'cpu']\n"
        f"runpy.run_path({str(TOOLS / 'torch_room_detection.py')!r}, run_name='__main__')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _NO_JAX + code], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PASS" in res.stdout
