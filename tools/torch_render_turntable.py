#!/usr/bin/env python3
"""Turntable render of a mesh on the PyTorch + CUDA port: a rotating-view PNG
sequence and, optionally, an animated GIF.

    python3 tools/torch_render_turntable.py mesh.ply --frames 24 --out-dir tt/ --gif tt/turntable.gif
    python3 tools/torch_render_turntable.py mesh.ply --frames 4 --width 160 --height 120 --device cpu

The counterpart of `tools/render_turntable.py` for `onepiece_tpu_torch`:
the camera orbits the mesh's centroid on a circle and each view is
rasterised on the run's device by `viz/render.render_mesh` (all faces at
once). The PNGs go through the port's encoder (`io/png.py`); the GIF writer
is a copy of the JAX tool's, byte for byte. Also reachable as
`tools/torch_fused_fusion.py --turntable DIR` and `tools/torch_dense_fusion.py
--turntable DIR`. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_common import add_device_arg  # noqa: E402
from onepiece_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from onepiece_tpu_torch.io.png import write_png  # noqa: E402
from onepiece_tpu_torch.io.ply import read_ply  # noqa: E402
from onepiece_tpu_torch.viz.render import render_mesh, to_uint8  # noqa: E402


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """Camera-to-world with +z looking from eye toward target."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, np.float64)
    right = np.cross(upv, fwd)
    right /= np.linalg.norm(right)
    upo = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, upo, fwd, eye
    return T


def turntable_camera(width: int, height: int) -> PinholeCamera:
    return PinholeCamera(fx=0.9 * width, fy=0.9 * width, cx=(width - 1) / 2.0, cy=(height - 1) / 2.0,
                         width=width, height=height, depth_scale=1000.0)


def turntable_poses(center: np.ndarray, radius: float, frames: int, elevation: float = 0.35,
                    arc_deg: float = 360.0, start_deg: float = 0.0) -> list[np.ndarray]:
    """The views' camera-to-world poses: a full circle from start_deg, or a
    partial arc of arc_deg centred on start_deg."""
    partial = arc_deg < 359.0
    poses = []
    for i in range(frames):
        if partial:
            a = np.deg2rad(start_deg + (i / max(frames - 1, 1) - 0.5) * arc_deg)
        else:
            a = np.deg2rad(start_deg) + 2.0 * np.pi * i / frames
        poses.append(look_at(center + radius * np.array([np.sin(a), -elevation, -np.cos(a)]), center))
    return poses


def render_turntable(
    vertices: torch.Tensor,  # (V, 3) on the device the views are rendered on
    faces: torch.Tensor,
    out_dir: str,
    colors: torch.Tensor | None = None,
    frames: int = 24,
    width: int = 640,
    height: int = 480,
    elevation: float = 0.35,
    gif: str | None = None,
    arc_deg: float = 360.0,
    start_deg: float = 0.0,
) -> list[str]:
    """Write `frames` orbit views of the mesh; returns the PNG paths.

    arc_deg < 360 sweeps a partial arc centred on start_deg and appends
    the reversed frames so the GIF ping-pongs smoothly (useful when the
    mesh is open on one side, e.g. a room scanned from within)."""
    os.makedirs(out_dir, exist_ok=True)
    v = vertices.cpu().numpy()
    center = v.mean(axis=0)
    radius = 2.2 * float(np.abs(v - center).max())
    cam = turntable_camera(width, height)
    paths, images = [], []
    for i, T_wc in enumerate(turntable_poses(center, radius, frames, elevation, arc_deg, start_deg)):
        img = to_uint8(render_mesh(vertices, faces, cam, T_wc, colors=colors))
        path = os.path.join(out_dir, f"turntable_{i:03d}.png")
        write_png(path, img)
        paths.append(path)
        images.append(img)
        print(f"  view {i + 1}/{frames} -> {path}", flush=True)
    if gif:
        seq = images + images[-2:0:-1] if arc_deg < 359.0 else images
        write_gif(gif, seq)
        print(f"gif -> {gif}")
    return paths


def write_gif(path: str, frames: list[np.ndarray], delay_cs: int = 8) -> None:
    """Minimal animated GIF writer (web-safe 6x6x6 palette, no deps): the
    bytes of the JAX tool's `_write_gif` for the same frames."""
    h, w, _ = frames[0].shape
    # 6-level-per-channel palette (216 colors)
    levels = np.array([0, 51, 102, 153, 204, 255], np.uint8)
    palette = bytearray()
    for r in levels:
        for g in levels:
            for b in levels:
                palette += bytes((r, g, b))
    palette += bytes(3 * (256 - 216))

    def quantise(img):
        q = np.clip((img.astype(np.int32) + 25) // 51, 0, 5)
        return (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(np.uint8)

    def lzw_encode(indices: np.ndarray, min_code: int = 8) -> bytes:
        # LZW for GIF (clear-code resets keep the dict small). A string is
        # keyed by its prefix's code and its last symbol (the JAX tool keys
        # it by its bytes): the same codes, emitted in the same order.
        clear = 1 << min_code
        end = clear + 1
        out = bytearray()
        bitbuf = 0
        bits = 0

        def emit(code, size):
            nonlocal bitbuf, bits
            bitbuf |= code << bits
            bits += size
            while bits >= 8:
                out.append(bitbuf & 0xFF)
                bitbuf >>= 8
                bits -= 8

        table: dict[int, int] = {}  # (prefix code << 8) | symbol -> code; single symbols are their own codes
        next_code = end + 1
        size = min_code + 1
        emit(clear, size)
        data = indices.tobytes()
        prev = data[0] if data else -1
        for sym in data[1:]:
            code = table.get((prev << 8) | sym)
            if code is not None:
                prev = code
                continue
            emit(prev, size)
            table[(prev << 8) | sym] = next_code
            next_code += 1
            if next_code == (1 << size) and size < 12:
                size += 1
            elif next_code >= 4096:
                emit(clear, size)
                table = {}
                next_code = end + 1
                size = min_code + 1
            prev = sym
        if prev >= 0:
            emit(prev, size)
        emit(end, size)
        if bits:
            out.append(bitbuf & 0xFF)
        return bytes(out)

    with open(path, "wb") as f:
        f.write(b"GIF89a")
        f.write(struct.pack("<HHBBB", w, h, 0xF7, 0, 0))
        f.write(bytes(palette))
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")  # loop forever
        for img in frames:
            f.write(b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00")
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            f.write(bytes((8,)))
            data = lzw_encode(quantise(img).reshape(-1))
            for i in range(0, len(data), 255):
                block = data[i : i + 255]
                f.write(bytes((len(block),)) + block)
            f.write(b"\x00")
        f.write(b"\x3b")


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mesh", type=str, help="PLY mesh to orbit")
    ap.add_argument("--out-dir", type=str, default="turntable")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--gif", type=str, default="", help="also write an animated GIF here")
    ap.add_argument("--arc", type=float, default=360.0, help="sweep arc in degrees (partial arcs ping-pong)")
    ap.add_argument("--start", type=float, default=0.0, help="arc centre / orbit start angle in degrees")
    ap.add_argument("--gain", type=float, default=1.0, help="brightness gain applied to vertex colors")
    ap.add_argument("--shaded-only", action="store_true", help="ignore vertex colors (geometry inspection)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    mesh = read_ply(args.mesh)
    colors = None if args.shaded_only else mesh.get("colors")
    if colors is not None and args.gain != 1.0:
        colors = np.clip(colors * args.gain, 0.0, 1.0)
    print(f"mesh: {len(mesh['vertices'])} verts, {len(mesh['faces'])} faces")
    t = time.perf_counter()
    paths = render_turntable(
        torch.from_numpy(mesh["vertices"]).to(args.device), torch.from_numpy(mesh["faces"]).to(args.device),
        args.out_dir, colors=None if colors is None else torch.from_numpy(np.asarray(colors, np.float32)).to(args.device),
        frames=args.frames, width=args.width, height=args.height,
        gif=args.gif or None, arc_deg=args.arc, start_deg=args.start,
    )
    print(f"{len(paths)} views in {time.perf_counter() - t:.2f}s")
    return paths


if __name__ == "__main__":
    main()
