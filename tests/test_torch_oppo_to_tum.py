"""`tools/torch_oppo_to_tum.py` against the JAX package's `tools/oppo_to_tum.py`
on a synthetic 2-frame Oppo folder (1920x1080 colour, 16-bit depth): the
decoded pixels equal the 960x540 centre crop and the depth as written, and
`associate.txt` is byte-equal to the JAX tool's (which runs where cv2
imports: it reads and writes through cv2)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from onepiece_tpu_torch.io import png

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import torch_oppo_to_tum  # noqa: E402


@pytest.fixture(scope="module")
def oppo(tmp_path_factory):
    root = tmp_path_factory.mktemp("oppo")
    rng = np.random.default_rng(0)
    rgbs, depths = [], []
    for i in range(2):
        rgbs.append(rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8))
        depths.append(rng.integers(0, 8000, (540, 960), dtype=np.uint16))
        png.write_png(str(root / f"rgb{i:04d}.png"), rgbs[-1])
        png.write_png(str(root / f"d{i:04d}.png"), depths[-1])
    (root / "_info.txt").write_text("2\n")
    return root, rgbs, depths


def test_oppo_to_tum_crops_and_associates(oppo, tmp_path):
    root, rgbs, depths = oppo
    assert torch_oppo_to_tum.main([str(root), str(tmp_path / "port")]) == 0
    lines = (tmp_path / "port" / "associate.txt").read_text().splitlines()
    assert len(lines) == 2
    for i, line in enumerate(lines):
        ts, rn, ts2, dn = line.split()
        assert ts == ts2 == f"{i / 30.0:.6f}"
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "port" / rn)), rgbs[i][270:810, 480:1440])
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "port" / dn)), depths[i])
    pytest.importorskip("cv2")
    res = subprocess.run([sys.executable, str(REPO / "tools" / "oppo_to_tum.py"), str(root), str(tmp_path / "jax")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "jax" / "associate.txt").read_bytes() == (tmp_path / "port" / "associate.txt").read_bytes()
    for line in lines:
        for name in line.split()[1::2]:
            np.testing.assert_array_equal(png.read_png(str(tmp_path / "jax" / name)),
                                          png.read_png(str(tmp_path / "port" / name)))


def test_oppo_to_tum_stops_at_a_missing_frame(oppo, tmp_path):
    root, _, _ = oppo
    (tmp_path / "in").mkdir()
    for name in ("_info.txt", "rgb0000.png", "d0000.png", "rgb0001.png"):  # frame 1's depth is missing
        (tmp_path / "in" / name).write_bytes((root / name).read_bytes())
    assert torch_oppo_to_tum.main([str(tmp_path / "in"), str(tmp_path / "out")]) == 0
    assert len((tmp_path / "out" / "associate.txt").read_text().splitlines()) == 1
