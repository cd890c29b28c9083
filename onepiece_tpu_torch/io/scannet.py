"""ScanNet-format sequence IO. Port of `onepiece_tpu/io/scannet.py`.

Reads the exported `_info.txt` (intrinsics, `m_depthShift`, frame count)
and the per-frame `frame-XXXXXX.color.jpg` / `.depth.pgm` / `.pose.txt`
files, resamples colour onto the depth camera's grid, converts an export to
the TUM layout and reads the instance labels. The JAX package reads the
images with cv2; the port decodes them with its own readers (`io/jpeg.py`,
bit-equal to cv2's libjpeg-turbo decode; `io/pgm.py`) and resamples with
its own remap (`native/remap.cpp`, bit-equal to cv2.remap's), so the card's
machine, which has no cv2, reads the same frames. Everything here is host
numpy, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import json
import os

import numpy as np

from .. import _native
from ..geometry.camera import PinholeCamera
from . import jpeg, pgm
from .png import write_png

_FP = ctypes.POINTER(ctypes.c_float)
_REMAP_SIGNATURES = {
    # src (h, w, 3), src h, src w, map_x, map_y, out h, out w, out (out h, out w, 3)
    "remap_linear_rgb": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _FP, _FP, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p],
}


def read_info(path: str) -> dict:
    """Parse a ScanNet `_info.txt` into a dict."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            if "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def camera_from_info(info: dict, depth: bool = True) -> PinholeCamera:
    key = "m_calibrationDepthIntrinsic" if depth else "m_calibrationColorIntrinsic"
    vals = [float(x) for x in info[key].split()]
    m = np.array(vals).reshape(4, 4)
    w = int(info["m_depthWidth" if depth else "m_colorWidth"])
    h = int(info["m_depthHeight" if depth else "m_colorHeight"])
    shift = float(info.get("m_depthShift", 1000.0))
    return PinholeCamera(fx=m[0, 0], fy=m[1, 1], cx=m[0, 2], cy=m[1, 2], width=w, height=h, depth_scale=shift)


def read_color(path: str) -> np.ndarray | None:
    """A colour frame as (H, W, 3) uint8 RGB (a gray JPEG repeated in all
    three channels, as cv2.IMREAD_COLOR gives it), or None when the file is
    missing. A file the decoder cannot read raises."""
    if not os.path.exists(path):
        return None
    img = jpeg.read_jpeg(path)
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img


class ScanNetSequence:
    """Iterates (frame_idx, rgb (H, W, 3) uint8 | None, depth (H, W) f32 m, pose (4, 4) f64)."""

    def __init__(self, root: str, max_frames: int | None = None):
        self.root = root
        self.info = read_info(os.path.join(root, "_info.txt"))
        self.camera = camera_from_info(self.info, depth=True)
        self.color_camera = camera_from_info(self.info, depth=False)
        n = int(self.info.get("m_frames.size", 0))
        self.num_frames = min(n, max_frames) if max_frames else n

    def __len__(self):
        return self.num_frames

    def __getitem__(self, i: int):
        base = os.path.join(self.root, f"frame-{i:06d}")
        rgb = read_color(base + ".color.jpg")
        depth = pgm.read_pgm(base + ".depth.pgm").astype(np.float32) / self.camera.depth_scale
        pose = np.loadtxt(base + ".pose.txt").reshape(4, 4)
        if rgb is not None and rgb.shape[:2] != depth.shape:
            rgb = align_color_to_depth(rgb, self.color_camera, self.camera)
        return i, rgb, depth, pose


def remap_linear(img: np.ndarray, map_u: np.ndarray, map_v: np.ndarray) -> np.ndarray:
    """`cv2.remap(img, map_u, map_v, cv2.INTER_LINEAR)` (constant border 0)
    for a uint8 (H, W, 3) image and float32 maps, bit for bit."""
    src = np.ascontiguousarray(img, np.uint8)
    mu = np.ascontiguousarray(map_u, np.float32)
    mv = np.ascontiguousarray(map_v, np.float32)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"remap needs an (H, W, 3) image, got {src.shape}")
    if mu.shape != mv.shape or mu.ndim != 2:
        raise ValueError(f"maps of shapes {mu.shape} and {mv.shape}")
    if not (np.isfinite(mu).all() and np.isfinite(mv).all()):
        raise ValueError("remap coordinates must be finite")
    out = np.empty(mu.shape + (3,), np.uint8)
    lib = _native.load(_native.REMAP_SOURCE, _REMAP_SIGNATURES)
    lib.remap_linear_rgb(src.ctypes.data, src.shape[0], src.shape[1], mu.ctypes.data_as(_FP),
                         mv.ctypes.data_as(_FP), mu.shape[0], mu.shape[1], out.ctypes.data)
    return out


def depth_grid_map(color_cam: PinholeCamera, depth_cam: PinholeCamera) -> tuple[np.ndarray, np.ndarray]:
    """(map_u, map_v) (H, W) float32: the colour pixel under each depth
    pixel (same extrinsics, intrinsics rescaled), computed in float64 and
    cast, as the JAX package computes it."""
    h, w = depth_cam.height, depth_cam.width
    u = (np.arange(w) - depth_cam.cx) / depth_cam.fx * color_cam.fx + color_cam.cx
    v = (np.arange(h) - depth_cam.cy) / depth_cam.fy * color_cam.fy + color_cam.cy
    map_u, map_v = np.meshgrid(u.astype(np.float32), v.astype(np.float32))
    return map_u, map_v


def align_color_to_depth(rgb: np.ndarray, color_cam: PinholeCamera, depth_cam: PinholeCamera) -> np.ndarray:
    """Resample the color image onto the depth camera's pixel grid."""
    return remap_linear(rgb, *depth_grid_map(color_cam, depth_cam))


def scannet_to_tum(root: str, out: str, max_frames: int | None = None) -> None:
    """Convert a ScanNet export to TUM layout: the JAX converter's listings
    byte for byte and its images pixel for pixel (PNGs written by
    `io/png.py`). A frame whose pose is not finite, or that has no colour
    file, raises `ValueError` naming it (the JAX converter fails inside
    scipy or cv2 there)."""
    from scipy.spatial.transform import Rotation

    seq = ScanNetSequence(root, max_frames)
    os.makedirs(os.path.join(out, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(len(seq)):
        _, rgb, depth, pose = seq[i]
        name = os.path.join(root, f"frame-{i:06d}")
        if not np.isfinite(pose).all():
            raise ValueError(f"{name}.pose.txt: the pose is not finite; a TUM ground truth cannot hold it")
        if rgb is None:
            raise ValueError(f"{name}.color.jpg: missing")
        ts = i / 30.0
        write_png(os.path.join(out, f"rgb/{ts:.6f}.png"), rgb)
        d16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
        write_png(os.path.join(out, f"depth/{ts:.6f}.png"), d16)
        rgb_lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        depth_lines.append(f"{ts:.6f} depth/{ts:.6f}.png")
        q = Rotation.from_matrix(pose[:3, :3]).as_quat()
        t = pose[:3, 3]
        gt_lines.append(
            f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines), ("groundtruth.txt", gt_lines)):
        with open(os.path.join(out, name), "w") as f:
            f.write("# converted from scannet\n" + "\n".join(lines) + "\n")


def read_instance_info(root: str) -> tuple[np.ndarray, list[str]]:
    """ScanNet instance labels: per-mesh-vertex object id (-1 unlabelled).

    Parses `<scene>_vh_clean.segs.json` (segIndices: vertex -> segment) and
    `<scene>_vh_clean.aggregation.json` (segGroups: object -> segments,
    label) and composes them. Returns (point2object (V,) int32, object names).
    """
    scene = os.path.basename(os.path.normpath(root))
    with open(os.path.join(root, scene + "_vh_clean.segs.json")) as f:
        point2segment = np.asarray(json.load(f)["segIndices"], np.int64)
    with open(os.path.join(root, scene + "_vh_clean.aggregation.json")) as f:
        groups = json.load(f)["segGroups"]
    names = [g.get("label", "") for g in groups]
    segment2object: dict[int, int] = {}
    for oid, g in enumerate(groups):
        for seg in g["segments"]:
            segment2object[int(seg)] = oid
    point2object = np.full(len(point2segment), -1, np.int32)
    for i, seg in enumerate(point2segment):
        point2object[i] = segment2object.get(int(seg), -1)
    return point2object, names
