"""The port's prefetch ring (`onepiece_tpu_torch/io/native_loader.py`,
workers `io/tum_frames.py`) against the eager decode and against the JAX
package's `PrefetchingRGBDLoader`.

- Over a 7-frame 80x60 folder the port writes (7 is a multiple of none of
  the thread and ring counts), for every n_threads in {1, 2, 3} and ring in
  {1, 2, 4}, gray and rgb, every frame is bit-equal to the eager decode
  (`TumSequence[i]`: depth, and the integer luma fold computed here from its
  rgb, / 255), in order; also with more workers than the host has cores.
- Over folders the JAX package writes (OpenCV's encoder, plain and with the
  sensor model), the ring equals the eager decode and the JAX loader with
  `gray=False`; gray is compared with the JAX loader only where it took its
  native path (its imageio fallback folds luma in float).
- A truncated or missing file raises at its frame, naming the file; a
  worker killed mid-pass makes the consumer raise; no worker is left after
  the raise, after `close()`, after an early `break` or after garbage
  collection.

Torch is pinned to one intra-op thread while the module runs.
"""

import gc
import os
import shutil

import numpy as np
import pytest
import torch

from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.io import tum as jtum
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.io import tum
from onepiece_tpu_torch.io.native_loader import PrefetchingRGBDLoader

CAM80, JCAM80 = TUM_CAMERA.pyramid(4)[3], JCAM.pyramid(4)[3]
N_FRAMES = 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port"))
    tum.write_synthetic_tum(root, num_frames=N_FRAMES, camera=CAM80, device="cpu")
    return root


@pytest.fixture(scope="module")
def jax_folders(tmp_path_factory):
    out = {}
    for corrupt in (False, True):
        root = str(tmp_path_factory.mktemp("jax_corrupt" if corrupt else "jax_plain"))
        jtum.write_synthetic_tum(root, num_frames=3, camera=JCAM80, corrupt=corrupt)
        out[corrupt] = root
    return out


def eager(root: str, gray: bool) -> list:
    """(depth, image) of each frame: `TumSequence[i]`, the fold written out here."""
    seq = tum.TumSequence(root)
    out = []
    for i in range(len(seq)):
        _, rgb, depth = seq[i]
        c = rgb.astype(np.int64)
        img = ((299 * c[..., 0] + 587 * c[..., 1] + 114 * c[..., 2]) // 1000).astype(np.uint8) if gray else rgb
        out.append((depth, img.astype(np.float32) / 255.0))
    return out


def assert_frames_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for (d, g), (wd, wg) in zip(got, want):
        assert d.dtype == g.dtype == np.float32 and d.shape == wd.shape and g.shape == wg.shape
        assert np.array_equal(d, wd) and np.array_equal(g, wg)


def alive(loader: PrefetchingRGBDLoader) -> list:
    return [p.pid for p in loader.workers if p.poll() is None]


@pytest.mark.parametrize("ring", [1, 2, 4])
@pytest.mark.parametrize("n_threads", [1, 2, 3])
def test_ring_equals_eager_decode(port_folder, n_threads, ring):
    for gray in (True, False):
        loader = tum.TumSequence(port_folder).stream(gray=gray, n_threads=n_threads, ring=ring)
        assert len(loader.workers) == n_threads and len(loader) == N_FRAMES
        assert_frames_equal(list(loader), eager(port_folder, gray))
        assert alive(loader) == []


def test_ring_with_more_workers_than_cores(port_folder):
    """Twice as many workers as the host has cores (at most one a frame),
    and a ring of 3: frames in order, equal to the eager decode."""
    pairs = [(os.path.join(port_folder, d), os.path.join(port_folder, r))
             for _, r, d in tum.TumSequence(port_folder).pairs] * 3
    loader = PrefetchingRGBDLoader(pairs, gray=True, n_threads=2 * os.cpu_count(), ring=3)
    assert len(loader.workers) == min(2 * os.cpu_count(), len(pairs))
    assert_frames_equal(list(loader), eager(port_folder, True) * 3)
    assert alive(loader) == []


@pytest.mark.parametrize("corrupt", [False, True])
def test_ring_on_jax_folders_equals_eager_and_the_jax_loader(jax_folders, corrupt):
    root = jax_folders[corrupt]
    seq, jseq = tum.TumSequence(root), jtum.TumSequence(root)
    for gray in (True, False):
        ours = list(seq.stream(gray=gray))
        assert_frames_equal(ours, eager(root, gray))
        jax_loader = jseq.stream(gray=gray)
        if gray and jax_loader._native is None:
            continue  # the imageio fallback folds luma in float
        assert_frames_equal(ours, list(jax_loader))


def broken_copy(src: str, dst, how: str) -> str:
    """A copy of the folder with frame 4's depth PNG truncated or missing."""
    root = str(dst / how)
    shutil.copytree(src, root)
    path = os.path.join(root, tum.TumSequence(root).pairs[4][2])
    if how == "truncated":
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])
    else:
        os.remove(path)
    return path


@pytest.mark.parametrize("how, error", [("truncated", ValueError), ("missing", FileNotFoundError)])
def test_a_bad_file_raises_at_its_frame(port_folder, tmp_path, how, error):
    path = broken_copy(port_folder, tmp_path, how)
    loader = tum.TumSequence(os.path.dirname(os.path.dirname(path))).stream(gray=True, n_threads=2, ring=4)
    got = []
    with pytest.raises(error, match="frame 4: .*" + os.path.basename(path)):
        for frame in loader:
            got.append(frame)
    assert_frames_equal(got, eager(port_folder, True)[:4])
    assert alive(loader) == []


def test_a_dead_worker_raises_and_nothing_hangs(port_folder):
    loader = tum.TumSequence(port_folder).stream(gray=True, n_threads=2, ring=2)
    it = iter(loader)
    next(it)
    loader.workers[1].kill()
    loader.workers[1].wait(10)
    # frame 1 may have been decoded before the kill; frame 3 cannot have been
    with pytest.raises(RuntimeError, match="decoder process .* before frame [13] "):
        for _ in it:
            pass
    assert alive(loader) == []


def test_no_worker_outlives_the_loader(port_folder):
    seq = tum.TumSequence(port_folder)
    loader = seq.stream(gray=True, n_threads=3, ring=2)
    it = iter(loader)
    next(it)
    assert len(alive(loader)) == 3
    loader.close()
    loader.close()
    assert alive(loader) == []

    loader = seq.stream(gray=False, n_threads=2, ring=4)
    for i, _ in enumerate(loader):
        if i == 2:
            break
    gc.collect()
    assert alive(loader) == []
    with pytest.raises(RuntimeError, match="one pass"):
        next(iter(loader))

    loader = seq.stream(gray=True, n_threads=2, ring=4)
    workers = list(loader.workers)
    assert all(p.poll() is None for p in workers)
    del loader
    gc.collect()
    for p in workers:
        p.wait(10)
    assert all(p.poll() is not None for p in workers)
