"""The port's `viz/render.py` and turntable tool against the JAX package's
on the CPU.

- `render_mesh` against the JAX loop at 160x120 on a few hundred faces (two
  icospheres, one occluding the other, and a quad drawn twice at one depth
  with other colours: a depth tie, which the JAX loop resolves by the
  float32 rounding of the depth in its z-buffer): at least 99.9 % of pixels
  equal (the port reproduces that rule; on these inputs every pixel is
  equal, and the tie is held pixel for pixel).
  Chunked by a small fragment budget, the image is bit-equal to one chunk.
- `save_depth_png`: each valid pixel equal to `matplotlib.cm.turbo` of
  depth / max_depth (float32), quantised with `bytes=True`; pixels without
  depth white. Skips where matplotlib is absent (the card's machine).
- The turntable's poses equal the JAX tool's `look_at` orbit; its views
  (decoded from the port's PNGs) against the JAX tool's PNGs: at least
  99.9 % of pixels equal; `write_gif` bytes equal to the JAX tool's
  `_write_gif` on the same frames.
Torch is pinned to one intra-op thread while the module runs.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from onepiece_tpu.geometry.camera import PinholeCamera as JCam
from onepiece_tpu.viz import render as jrender
from onepiece_tpu_torch.geometry.camera import PinholeCamera as TCam
from onepiece_tpu_torch.io.png import read_png
from onepiece_tpu_torch.viz import render as trender
from test_mesh import icosphere

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import render_turntable as jturntable  # noqa: E402
import torch_render_turntable as tturntable  # noqa: E402

W, H = 160, 120
CAM = dict(fx=0.9 * W, fy=0.9 * W, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0, width=W, height=H, depth_scale=1000.0)
MIN_EQUAL = 0.999


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scene(seed=0):
    """Two icospheres (the smaller in front of the larger) and a quad drawn
    twice at one depth, the copies with other vertex colours: 404 faces."""
    v1, f1 = icosphere(2, 0.5)
    v2, f2 = icosphere(1, 0.3)
    v2 = v2 + np.array([0.3, 0.1, -0.4], np.float32)
    quad = np.array([[-0.6, -0.6, -0.8], [0.2, -0.6, -0.8], [0.2, 0.2, -0.8], [-0.6, 0.2, -0.8]], np.float32)
    qf = np.array([[0, 1, 2], [0, 2, 3]])
    v = np.concatenate([v1, v2, quad, quad]).astype(np.float32)
    n = len(v1) + len(v2)
    f = np.concatenate([f1, f2 + len(v1), qf + n, qf + n + 4])
    c = np.random.default_rng(seed).uniform(0, 1, v.shape).astype(np.float32)
    return v, f, c


def pose(tx=0.05, ty=0.02, tz=-2.0):
    T = np.eye(4)
    T[:3, 3] = [tx, ty, tz]
    return T


def equal_share(a: np.ndarray, b: np.ndarray) -> float:
    return float((a == b).all(-1).mean())


@pytest.mark.parametrize("coloured", [False, True])
@pytest.mark.parametrize("view", ["front", "side", "close"])
def test_render_mesh_against_the_jax_loop(coloured, view):
    v, f, c = scene()
    T = {"front": pose(), "side": jturntable.look_at(np.array([1.8, -0.4, -0.6]), np.zeros(3)),
         "close": pose(0.1, 0.0, -1.1)}[view]
    c = c if coloured else None
    j = jrender.render_mesh(v, f, JCam(**CAM), T, c)
    t = trender.render_mesh(torch.from_numpy(v), torch.from_numpy(f), TCam(**CAM), T,
                            None if c is None else torch.from_numpy(c)).numpy()
    assert t.dtype == np.float32 and t.shape == (H, W, 3)
    assert (j.sum(-1) > 0).mean() > 0.1
    assert equal_share(t, j) >= MIN_EQUAL


def test_render_depth_tie_resolves_as_the_jax_loop():
    """The quad's two copies lie at one depth. The JAX loop keeps the later
    copy where the first copy's depth rounded up in its float32 z-buffer, so
    both copies show; the port gives the same pixels."""
    v, f, c = scene()
    quads = f[-4:]
    j = jrender.render_mesh(v, quads, JCam(**CAM), pose(), c)
    t = trender.render_mesh(torch.from_numpy(v), torch.from_numpy(quads), TCam(**CAM), pose(),
                            torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(t, j)
    for copy in (quads[:2], quads[2:]):
        own = trender.render_mesh(torch.from_numpy(v), torch.from_numpy(copy), TCam(**CAM), pose(),
                                  torch.from_numpy(c)).numpy()
        assert ((t == own).all(-1) & own.any(-1)).sum() > 100


def test_render_in_chunks_is_bit_equal(monkeypatch):
    v, f, c = scene()
    args = (torch.from_numpy(v), torch.from_numpy(f), TCam(**CAM), pose(0.1, 0.0, -1.1), torch.from_numpy(c))
    whole = trender.render_mesh(*args)
    monkeypatch.setattr(trender, "FRAGMENT_BUDGET", 97)
    np.testing.assert_array_equal(trender.render_mesh(*args).numpy(), whole.numpy())


def test_render_nothing_in_view():
    v, f, _ = scene()
    behind = pose(0.0, 0.0, 3.0)  # every vertex behind the camera
    t = trender.render_mesh(torch.from_numpy(v), torch.from_numpy(f), TCam(**CAM), behind)
    np.testing.assert_array_equal(t.numpy(), jrender.render_mesh(v, f, JCam(**CAM), behind))
    assert not t.any()
    empty = trender.render_mesh(torch.from_numpy(v), torch.zeros((0, 3), dtype=torch.int64), TCam(**CAM), pose())
    assert empty.shape == (H, W, 3) and not empty.any()


def test_save_mesh_png_round_trips(tmp_path):
    v, f, c = scene()
    args = (torch.from_numpy(v), torch.from_numpy(f), TCam(**CAM), pose(), torch.from_numpy(c))
    trender.save_mesh_png(str(tmp_path / "m.png"), *args)
    np.testing.assert_array_equal(read_png(str(tmp_path / "m.png")), trender.to_uint8(trender.render_mesh(*args)))


def test_save_depth_png_is_matplotlib_turbo(tmp_path):
    cm = pytest.importorskip("matplotlib.cm")
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.0, 5.0, (48, 64)).astype(np.float32)
    depth[::5, ::3] = 0.0
    depth[1, :4] = [4.0, 3.9999998, 1e-9, 8.0]  # the top entry, just below it, the bottom, over the range
    trender.save_depth_png(str(tmp_path / "d.png"), torch.from_numpy(depth), max_depth=4.0)
    img = read_png(str(tmp_path / "d.png"))
    assert img.shape == (48, 64, 3)
    valid = depth > 0
    expect = cm.turbo(depth / np.float32(4.0), bytes=True)[..., :3]
    np.testing.assert_array_equal(img[valid], expect[valid])
    assert (img[~valid] == 255).all()


def test_save_gray_png_levels(tmp_path):
    gray = np.linspace(0.2, 0.7, 256, dtype=np.float32).reshape(16, 16)
    trender.save_gray_png(str(tmp_path / "g.png"), torch.from_numpy(gray))
    img = read_png(str(tmp_path / "g.png"))
    assert img.shape == (16, 16, 3) and (img[..., 0] == img[..., 2]).all()
    assert img[0, 0, 0] == 0 and img[-1, -1, 0] == 255 and (np.diff(img[..., 0].reshape(-1).astype(int)) >= 0).all()


def test_save_trajectory_png(tmp_path):
    from onepiece_tpu_torch.utils import synthetic

    gt = synthetic.orbit_trajectory(16)
    est = gt.copy()
    est[:, 0, 3] += 0.05
    trender.save_trajectory_png(str(tmp_path / "t.png"), est, gt)
    img = read_png(str(tmp_path / "t.png"))
    assert img.shape == (trender.TRAJECTORY_SIZE, trender.TRAJECTORY_SIZE, 3)
    for rgb in (trender._ESTIMATE_RGB, trender._GT_RGB):
        assert (img == rgb).all(-1).sum() > 50


@pytest.mark.parametrize("arc", [360.0, 120.0])
def test_turntable_against_the_jax_tool(tmp_path, arc):
    v, f, c = scene()
    kw = dict(frames=3, width=W, height=H, arc_deg=arc, start_deg=30.0)
    jpaths = jturntable.render_turntable(v, f, str(tmp_path / "j"), colors=c, gif=str(tmp_path / "j.gif"), **kw)
    tpaths = tturntable.render_turntable(torch.from_numpy(v), torch.from_numpy(f), str(tmp_path / "t"),
                                         colors=torch.from_numpy(c), gif=str(tmp_path / "t.gif"), **kw)
    center = v.mean(0)
    radius = 2.2 * float(np.abs(v - center).max())
    for i, T in enumerate(tturntable.turntable_poses(center, radius, 3, arc_deg=arc, start_deg=30.0)):
        a = np.deg2rad(30.0 + (i / 2 - 0.5) * arc) if arc < 359 else np.deg2rad(30.0) + 2 * np.pi * i / 3
        eye = center + radius * np.array([np.sin(a), -0.35, -np.cos(a)])
        np.testing.assert_array_equal(T, jturntable.look_at(eye, center))
    frames = []
    for jp, tp in zip(jpaths, tpaths):
        a, b = read_png(jp), read_png(tp)
        assert equal_share(a, b) >= MIN_EQUAL
        frames.append(b)
    if all(np.array_equal(read_png(jp), fr) for jp, fr in zip(jpaths, frames)):
        assert (tmp_path / "t.gif").read_bytes() == (tmp_path / "j.gif").read_bytes()


def test_gif_bytes_equal_the_jax_writer(tmp_path):
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (40, 56, 3), dtype=np.uint8) for _ in range(3)]
    frames.append(np.zeros((40, 56, 3), np.uint8))
    frames.append(np.full((40, 56, 3), 200, np.uint8))  # long runs: the LZW table fills and resets
    for seq in (frames, [np.full((1, 1, 3), 7, np.uint8)]):
        jturntable._write_gif(str(tmp_path / "j.gif"), seq)
        tturntable.write_gif(str(tmp_path / "t.gif"), seq)
        assert (tmp_path / "t.gif").read_bytes() == (tmp_path / "j.gif").read_bytes()
