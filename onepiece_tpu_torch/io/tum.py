"""TUM RGB-D dataset IO.

Port of `onepiece_tpu/io/tum.py`: parses the `rgb.txt` / `depth.txt`
listings (or a pre-associated `associate.txt`), pairs colour and depth by
nearest timestamp, decodes the PNGs with the port's own codec
(`io/png.py`: the card's machine has no libpng bindings and no OpenCV),
scales 16-bit depth by the camera's depth_scale, and reads
`groundtruth.txt`. `write_synthetic_tum` renders a synthetic sequence into
the same on-disk format, so every tool can run without a dataset.

`TumSequence.stream` decodes in the calling thread, a batch of frames'
PNGs at a time (their row-filter sweeps shared); the JAX package's native
prefetch ring (`io/native_loader.py`) is not ported. Its gray is the native
loader's integer luma fold, so both packages feed their systems the same
numbers.
"""

from __future__ import annotations

import os

import numpy as np

from . import png

# frames whose PNGs `TumSequence.stream` decodes together: their row-filter
# sweeps share numpy's per-call cost; the sweep's int16 scratch is ~25 MB a
# 640x480 frame
DECODE_BATCH = 8


def _read_listing(path: str) -> list[tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def associate(
    a: list[tuple[float, str]], b: list[tuple[float, str]], max_dt: float = 0.02
) -> list[tuple[float, str, str]]:
    """Greedy nearest-timestamp association (TUM associate.py semantics)."""
    out = []
    bi = 0
    used = set()
    for ta, fa in a:
        best, best_dt = None, max_dt
        for j in range(max(0, bi - 3), len(b)):
            tb, fb = b[j]
            dt = abs(tb - ta)
            if dt <= best_dt and j not in used:
                best, best_dt = j, dt
            if tb > ta + max_dt:
                break
        if best is not None:
            used.add(best)
            bi = best
            out.append((ta, fa, b[best][1]))
    return out


def luma(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (H, W): (299 r + 587 g + 114 b) // 1000, the
    JAX package's native loader's fold (`native/rgbd_loader.cpp`)."""
    c = rgb.astype(np.int32)
    return ((299 * c[..., 0] + 587 * c[..., 1] + 114 * c[..., 2]) // 1000).astype(np.uint8)


def _as_rgb(img: np.ndarray, path: str) -> np.ndarray:
    """uint8 (H, W, 3): gray files repeat their channel, alpha is dropped."""
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: colour image of {img.dtype} samples, expected 8-bit")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[2] == 2:  # gray + alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def _as_depth16(img: np.ndarray, path: str) -> np.ndarray:
    if img.dtype != np.uint16 or img.ndim != 2:
        raise ValueError(f"{path}: depth image of {img.dtype} samples, shape {img.shape}; expected 16-bit gray")
    return img


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


class TumSequence:
    """Iterates (timestamp, rgb (H, W, 3) uint8, depth (H, W) float32 meters)."""

    def __init__(self, root: str, depth_scale: float = 5000.0, max_frames: int | None = None):
        self.root = root
        self.depth_scale = depth_scale
        assoc_path = os.path.join(root, "associate.txt")
        if os.path.exists(assoc_path):
            pairs = []
            with open(assoc_path) as f:
                for line in f:
                    p = line.split()
                    if len(p) >= 4:
                        pairs.append((float(p[0]), p[1], p[3]))
            self.pairs = pairs
        else:
            rgb = _read_listing(os.path.join(root, "rgb.txt"))
            depth = _read_listing(os.path.join(root, "depth.txt"))
            self.pairs = associate(rgb, depth)
        if max_frames:
            self.pairs = self.pairs[:max_frames]

    def __len__(self):
        return len(self.pairs)

    def _decode(self, pairs) -> list[tuple[np.ndarray, np.ndarray]]:
        """(rgb uint8 (H, W, 3), depth uint16 (H, W)) of each pair, every
        PNG of the pairs decoded together (`png.decode_many`)."""
        paths = [os.path.join(self.root, rel) for _, rgb_rel, depth_rel in pairs for rel in (rgb_rel, depth_rel)]
        imgs = png.decode_many([_read(p) for p in paths])
        return [(_as_rgb(imgs[2 * i], paths[2 * i]), _as_depth16(imgs[2 * i + 1], paths[2 * i + 1]))
                for i in range(len(pairs))]

    def __getitem__(self, i):
        ts = self.pairs[i][0]
        ((rgb, d16),) = self._decode(self.pairs[i : i + 1])
        return ts, rgb, d16.astype(np.float32) / self.depth_scale

    def stream(self, gray: bool = True):
        """Iterate (depth_m float32, gray float32 in [0, 1] or rgb float32
        (H, W, 3) in [0, 1]), decoded in the calling thread, DECODE_BATCH
        frames' PNGs at a time. Gray is the integer luma fold of the colour
        image, / 255."""
        for at in range(0, len(self.pairs), DECODE_BATCH):
            for rgb, d16 in self._decode(self.pairs[at : at + DECODE_BATCH]):
                img = luma(rgb) if gray else rgb
                yield d16.astype(np.float32) / self.depth_scale, img.astype(np.float32) / 255.0

    def groundtruth(self):
        """Returns (timestamps, poses (N, 4, 4)) from groundtruth.txt or None."""
        path = os.path.join(self.root, "groundtruth.txt")
        if not os.path.exists(path):
            return None
        from .trajectory import read_tum_trajectory

        return read_tum_trajectory(path)


def write_synthetic_tum(
    root: str,
    num_frames: int = 30,
    camera=None,
    num_steps: int = 64,
    corrupt: bool = False,
    corrupt_seed: int = 1000,
    textureless: tuple[int, int] | None = None,
    device="cuda",
) -> np.ndarray:
    """Render the synthetic orbit on `device` into TUM on-disk format;
    returns the ground-truth poses (N, 4, 4).

    `corrupt` applies the sensor model (`utils/synthetic.corrupt_rgbd`:
    depth noise, dropout holes, gray noise) with per-frame seeds, so the
    files equal `corrupt_sequence` of the same render after the PNG round
    trip. Gray is stored as R = G = B, which the luma fold gives back
    exactly."""
    import torch

    from ..geometry.camera import TUM_CAMERA
    from ..utils import synthetic
    from .trajectory import write_tum_trajectory

    camera = camera or TUM_CAMERA
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    scene = synthetic.default_scene(device)
    poses = synthetic.orbit_trajectory(num_frames)
    rgb_lines, depth_lines = [], []
    for i in range(num_frames):
        d, g = synthetic.render(
            scene, torch.from_numpy(poses[i]).to(device), camera.fx, camera.fy, camera.cx,
            camera.cy, camera.height, camera.width, num_steps=num_steps,
        )
        g, d = g.cpu().numpy(), d.cpu().numpy()
        if corrupt:
            rng = np.random.default_rng(corrupt_seed + i)
            c = 0.06 if textureless and textureless[0] <= i < textureless[1] else 1.0
            g, d = synthetic.corrupt_rgbd(rng, g, d, contrast=c)
        ts = i / 30.0
        g8 = np.clip(g * 255, 0, 255).astype(np.uint8)
        d16 = np.clip(d * camera.depth_scale, 0, 65535).astype(np.uint16)
        rn = f"rgb/{ts:.6f}.png"
        dn = f"depth/{ts:.6f}.png"
        png.write_png(os.path.join(root, rn), np.stack([g8, g8, g8], -1))
        png.write_png(os.path.join(root, dn), d16)
        rgb_lines.append(f"{ts:.6f} {rn}")
        depth_lines.append(f"{ts:.6f} {dn}")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# ts filename\n" + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("# ts filename\n" + "\n".join(depth_lines) + "\n")
    write_tum_trajectory(os.path.join(root, "groundtruth.txt"), np.arange(num_frames) / 30.0, poses)
    return poses
