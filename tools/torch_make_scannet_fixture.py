#!/usr/bin/env python3
"""Write the committed synthetic ScanNet fixture, `tests/data/scannet_synth/`.

    python3 tools/torch_make_scannet_fixture.py [--out tests/data/scannet_synth]

Renders FRAMES colour frames of the port's synthetic room at ScanNet's
colour camera (1296x968, the intrinsics of ScanNet's scene0000_00) along the
orbit trajectory, tints the shaded gray with smooth and sharp colour bands
(so the chroma upsampling has edges to get right), and writes them with
cv2 as ScanNet does: baseline JPEG, quality 90, 4:2:0. `manifest.json`
records the cameras, the poses and, for each frame, the SHA-256 of cv2's
decode (RGB, C order) and of cv2.remap of that decode onto the depth grid:
the references the port's decoder and remap are held to where there is no
cv2 (`chip_smoke.py`, on the card's machine). Needs cv2, so it runs where
OpenCV is installed.

`write_export` builds a ScanNet export around such colour files (depth as
16-bit PGM in millimetres, poses, `_info.txt`); it needs no cv2.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from onepiece_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from onepiece_tpu_torch.io.scannet import depth_grid_map  # noqa: E402
from onepiece_tpu_torch.utils import synthetic  # noqa: E402

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data",
                           "scannet_synth")
FRAMES = 8
DEPTH_SHIFT = 1000.0
COLOR_CAMERA = PinholeCamera(fx=1170.187988, fy=1170.187988, cx=647.75, cy=483.75, width=1296, height=968,
                             depth_scale=DEPTH_SHIFT)
DEPTH_CAMERA = PinholeCamera(fx=571.623718, fy=571.623718, cx=319.5, cy=239.5, width=640, height=480,
                             depth_scale=DEPTH_SHIFT)
QUALITY = 90
RENDER_STEPS = 96


def color_name(i: int) -> str:
    return f"frame-{i:06d}.color.jpg"


def tint(gray: np.ndarray) -> np.ndarray:
    """Shaded gray (H, W) in [0, 1] -> (H, W, 3) uint8 RGB: smooth colour
    waves times a checker of two hues whose edges fall off the 16-pixel MCU
    grid."""
    h, w = gray.shape
    v, u = np.mgrid[:h, :w].astype(np.float64)
    smooth = 0.8 + 0.2 * np.stack([np.sin(u / 97.0), np.sin(v / 61.0 + 1.0), np.sin((u + v) / 131.0 + 2.0)], -1)
    checker = (((u + 5) // 71 + (v + 3) // 53) % 2)[..., None]
    hue = np.where(checker > 0, [1.0, 0.7, 0.45], [0.55, 0.8, 1.0])
    return np.clip(np.rint(320.0 * gray[..., None] * smooth * hue), 0, 255).astype(np.uint8)


def render_color(pose: np.ndarray, device: str = "cpu") -> np.ndarray:
    c = COLOR_CAMERA
    _, gray = synthetic.render(synthetic.default_scene(device), torch.from_numpy(pose).to(device),
                               c.fx, c.fy, c.cx, c.cy, c.height, c.width, num_steps=RENDER_STEPS)
    return tint(gray.cpu().numpy().astype(np.float64))


def _matrix_text(cam: PinholeCamera) -> str:
    m = np.eye(4)
    m[0, 0], m[1, 1], m[0, 2], m[1, 2] = cam.fx, cam.fy, cam.cx, cam.cy
    return " ".join(f"{x:.6f}" for x in m.ravel())


def info_text(num_frames: int, color_cam: PinholeCamera, depth_cam: PinholeCamera) -> str:
    """A ScanNet `_info.txt` for these cameras."""
    eye = " ".join(f"{x:.6f}" for x in np.eye(4).ravel())
    return (
        "m_versionNumber = 4\nm_sensorName = StructureSensor\n"
        f"m_colorWidth = {color_cam.width}\nm_colorHeight = {color_cam.height}\n"
        f"m_depthWidth = {depth_cam.width}\nm_depthHeight = {depth_cam.height}\n"
        f"m_depthShift = {depth_cam.depth_scale:g}\n"
        f"m_calibrationColorIntrinsic = {_matrix_text(color_cam)}\nm_calibrationColorExtrinsic = {eye}\n"
        f"m_calibrationDepthIntrinsic = {_matrix_text(depth_cam)}\nm_calibrationDepthExtrinsic = {eye}\n"
        f"m_frames.size = {num_frames}\n"
    )


def write_export(root: str, depths: np.ndarray, poses: np.ndarray, color_cam: PinholeCamera,
                 depth_cam: PinholeCamera, jpegs: list, untracked: tuple = ()) -> None:
    """A ScanNet export in `root`: frame i's colour file from `jpegs[i]`
    (bytes; None leaves it missing), its depth (H, W) metres as a 16-bit
    PGM at the camera's depth shift, its pose as text (-inf for frames in
    `untracked`, as ScanNet marks frames it lost), and `_info.txt`."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "_info.txt"), "w") as f:
        f.write(info_text(len(depths), color_cam, depth_cam))
    for i, (depth, pose) in enumerate(zip(depths, poses)):
        base = os.path.join(root, f"frame-{i:06d}")
        if jpegs[i] is not None:
            with open(base + ".color.jpg", "wb") as f:
                f.write(jpegs[i])
        mm = np.clip(np.rint(np.asarray(depth, np.float64) * depth_cam.depth_scale), 0, 65535).astype(">u2")
        with open(base + ".depth.pgm", "wb") as f:
            f.write(f"P5\n{mm.shape[1]} {mm.shape[0]}\n65535\n".encode() + mm.tobytes())
        p = np.full((4, 4), -np.inf) if i in untracked else np.asarray(pose, np.float64)
        np.savetxt(base + ".pose.txt", p, fmt="%.9g")


def sha256(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def main(argv=None) -> int:
    import cv2

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=FIXTURE_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    poses = synthetic.orbit_trajectory(FRAMES)
    map_u, map_v = depth_grid_map(COLOR_CAMERA, DEPTH_CAMERA)
    frames = []
    for i, pose in enumerate(poses):
        rgb = render_color(pose)
        ok, enc = cv2.imencode(".jpg", rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, QUALITY,
                                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
        if not ok:
            raise RuntimeError(f"cv2 could not encode frame {i}")
        with open(os.path.join(args.out, color_name(i)), "wb") as f:
            f.write(enc.tobytes())
        decoded = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
        aligned = cv2.remap(decoded, map_u, map_v, cv2.INTER_LINEAR)
        frames.append({"file": color_name(i), "bytes": len(enc), "decode_sha256": sha256(decoded),
                       "remap_sha256": sha256(aligned)})
        print(f"frame {i}: {len(enc)} bytes")
    cams = {name: {k: getattr(c, k) for k in ("fx", "fy", "cx", "cy", "width", "height", "depth_scale")}
            for name, c in (("color", COLOR_CAMERA), ("depth", DEPTH_CAMERA))}
    manifest = {
        "made_by": "tools/torch_make_scannet_fixture.py",
        "encoder": f"cv2 {cv2.__version__}, baseline JPEG quality {QUALITY}, 4:2:0",
        "hashes": "SHA-256 of the (H, W, 3) uint8 RGB image in C order: cv2.imdecode, and cv2.remap "
                  "(INTER_LINEAR, constant border 0) of it onto the depth grid of io/scannet.depth_grid_map",
        "cameras": cams,
        "render_steps": RENDER_STEPS,
        "poses": [p.astype(np.float64).tolist() for p in poses],
        "frames": frames,
    }
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"{FRAMES} frames -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
