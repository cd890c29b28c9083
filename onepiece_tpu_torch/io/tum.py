"""TUM RGB-D dataset IO.

Port of `onepiece_tpu/io/tum.py`: parses the `rgb.txt` / `depth.txt`
listings (or a pre-associated `associate.txt`), pairs colour and depth by
nearest timestamp, decodes the PNGs with the port's own codec
(`io/png.py`: the card's machine has no libpng bindings and no OpenCV),
scales 16-bit depth by the camera's depth_scale, and reads
`groundtruth.txt`. `write_synthetic_tum` renders a synthetic sequence into
the same on-disk format, so every tool can run without a dataset.

`TumSequence.stream` returns the prefetch ring (`io/native_loader.py`:
decoder processes that decode frame N + k while frame N runs), as the JAX
package's does. Its gray is the JAX native loader's integer luma fold, so
both packages feed their systems the same numbers; the ring's workers and
`TumSequence[i]` decode through `io/tum_frames.py`.
"""

from __future__ import annotations

import os

import numpy as np

from . import png
from .native_loader import N_WORKERS, RING, PrefetchingRGBDLoader
from .tum_frames import read_frames


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

    def __getitem__(self, i):
        ts, rgb_rel, depth_rel = self.pairs[i]
        ((rgb, d16),) = read_frames([(os.path.join(self.root, depth_rel), os.path.join(self.root, rgb_rel))])
        return ts, rgb, d16.astype(np.float32) / self.depth_scale

    def stream(self, gray: bool = True, n_threads: int = N_WORKERS, ring: int = RING) -> PrefetchingRGBDLoader:
        """The prefetch ring over the sequence: (depth_m float32, gray
        float32 in [0, 1] or rgb float32 (H, W, 3) in [0, 1]) frames, decoded
        by `n_threads` worker processes at most `ring` frames ahead. Gray is
        the integer luma fold of the colour image, / 255."""
        pairs = [(os.path.join(self.root, d), os.path.join(self.root, r)) for _, r, d in self.pairs]
        return PrefetchingRGBDLoader(pairs, depth_scale=self.depth_scale, gray=gray, n_threads=n_threads, ring=ring)

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
    poses: np.ndarray | None = None,
) -> np.ndarray:
    """Render the synthetic orbit (or the camera-to-world `poses` (N, 4, 4),
    e.g. `synthetic.loop_trajectory(N)`) on `device` into TUM on-disk
    format; returns the ground-truth poses (N, 4, 4).

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
    poses = synthetic.orbit_trajectory(num_frames) if poses is None else np.asarray(poses)[:num_frames]
    rgb_lines, depth_lines = [], []
    for i in range(len(poses)):
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
    write_tum_trajectory(os.path.join(root, "groundtruth.txt"), np.arange(len(poses)) / 30.0, poses)
    return poses
