"""TUM frames from their PNG files, and the prefetch ring's worker process.

`TumSequence` (`io/tum.py`) and the worker processes of
`PrefetchingRGBDLoader` (`io/native_loader.py`) decode through the
functions here, so the ring yields the eager reader's frames bit for bit:
depth in metres (16-bit samples / depth_scale) and gray by the JAX
package's native loader's integer luma fold (`native/rgbd_loader.cpp`), / 255,
or rgb / 255, all float32.

Run as a script, this file is one worker of the ring:

    python -P tum_frames.py FD HEIGHT WIDTH DEPTH_SCALE gray|rgb

It imports only the standard library, numpy and `png.py` beside it, loaded
from its file: the package's `__init__` imports torch, which costs a
process seconds and hundreds of MB. FD is a shared-memory file (memfd) of
ring slots, each a frame's depth (H, W) then its image (H, W) or (H, W, 3),
float32. Each line on stdin is a job, `[frame, slot, depth_path,
rgb_path]` in JSON; the worker decodes the frame into the slot and answers
on stdout `[frame, null]`, or `[frame, exception type, message]` naming the
file, in the order of the jobs. It exits at the end of its stdin.
"""

from __future__ import annotations

import json
import mmap
import os
import sys

import numpy as np

if __package__:
    from . import png
else:  # a worker process: png.py beside this file, not the package
    import importlib.util

    _spec = importlib.util.spec_from_file_location("png", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                                        "png.py"))
    png = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(png)


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


def read_frames(pairs: list[tuple[str, str]]) -> list[tuple[np.ndarray, np.ndarray]]:
    """(rgb uint8 (H, W, 3), depth uint16 (H, W)) of each (depth_path,
    rgb_path), every PNG of the pairs decoded together (`png.decode_many`)."""
    paths = [p for d, c in pairs for p in (c, d)]
    imgs = png.decode_many([_read(p) for p in paths], paths)
    return [(_as_rgb(imgs[2 * i], paths[2 * i]), _as_depth16(imgs[2 * i + 1], paths[2 * i + 1]))
            for i in range(len(pairs))]


def to_floats(rgb: np.ndarray, d16: np.ndarray, depth_scale: float, gray: bool) -> tuple[np.ndarray, np.ndarray]:
    """(depth float32 m, gray (H, W) or rgb (H, W, 3) float32 in [0, 1])."""
    img = luma(rgb) if gray else rgb
    return d16.astype(np.float32) / depth_scale, img.astype(np.float32) / 255.0


def _decode_jobs(jobs: list) -> list:
    """Each job's (rgb, d16), or the exception its files raised: the jobs'
    PNGs decoded together, or one job at a time if that fails."""
    try:
        return read_frames([(d, c) for _, _, d, c in jobs])
    except (OSError, ValueError):
        if len(jobs) == 1:
            return [sys.exc_info()[1]]
        return [_decode_jobs([job])[0] for job in jobs]


def serve(fd: int, height: int, width: int, depth_scale: float, gray: bool) -> None:
    """The worker's loop (see the module's docstring). The jobs waiting on
    stdin when the worker turns to it are decoded together: a frame's sweep
    costs ~H + W numpy steps whatever the batch, so a batch of k frames
    costs far less than k single ones."""
    mem = mmap.mmap(fd, 0)
    shape = (height, width) if gray else (height, width, 3)
    n_depth = height * width
    slot_floats = n_depth + int(np.prod(shape))
    pending = b""
    while data := os.read(sys.stdin.fileno(), 1 << 16):
        *lines, pending = (pending + data).split(b"\n")
        jobs = [json.loads(line) for line in lines]
        replies = []
        for (frame, slot, depth_path, rgb_path), got in zip(jobs, _decode_jobs(jobs) if jobs else []):
            try:
                if isinstance(got, Exception):
                    raise got
                rgb, d16 = got
                for path, size in ((depth_path, d16.shape), (rgb_path, rgb.shape[:2])):
                    if size != (height, width):
                        raise ValueError(f"{path}: {size[1]}x{size[0]} image, the sequence's first frame is "
                                         f"{width}x{height}")
                depth, img = to_floats(rgb, d16, depth_scale, gray)
                out = np.frombuffer(mem, np.float32, slot_floats, slot * slot_floats * 4)
                out[:n_depth] = depth.reshape(-1)
                out[n_depth:] = img.reshape(-1)
                del out
                replies.append([frame, None])
            except (OSError, ValueError) as e:
                replies.append([frame, type(e).__name__, str(e)])
        sys.stdout.write("".join(json.dumps(r) + "\n" for r in replies))
        sys.stdout.flush()


if __name__ == "__main__":
    serve(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4]), sys.argv[5] == "gray")
