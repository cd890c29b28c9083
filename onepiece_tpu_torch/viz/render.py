"""Offline visualisation: a software mesh renderer and image dumps.

Port of `onepiece_tpu/viz/render.py` (ref: src/Visualization/Visualizer.
{h,cpp}, DrawImage.h), without matplotlib, which the card's machine does
not have: every image is written through the port's PNG encoder
(`io/png.write_png`) at its own size, with none of matplotlib's figure
around it (no axes, no colour bar, no legend, no labels).

`render_mesh` is the redesign. The JAX package rasterises one face per
Python iteration into a z-buffer; here every face is rasterised at once on
the mesh's device: each face's pixel bounding box is expanded into
(face, pixel) fragments, chunked by faces to an element budget, with the
barycentrics and the depth computed in float64 by the JAX code's
expressions, operation for operation, so that edge pixels agree.

The z-test reproduces the JAX loop's rule exactly. The loop visits faces in
order and a fragment replaces the pixel's face when its float64 depth z is
strictly below the float32 z-buffer, which then holds z rounded to float32:
nearest wins and, at equal float32 depth, the order decides. Each fragment
gets an integer key K = 2 bits(float32(z)) - 1, 0 or + 1 as float32(z) is
above, equal to or below z, so that z < s for a float32 s exactly when K <
2 bits(s). The winner is then decided among the fragments at the pixel's
least key K* (and, where K* is even, also K* + 1): the lowest face index
among them whose z rounds down or is exact, else, all rounding up, the
highest. Three deterministic `scatter_reduce` passes (the least key, then
the lowest and the highest face index) find it, in any fragment order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.mesh import _cross, _norm3
from ..io.png import write_png
from .turbo import TURBO

FRAGMENT_BUDGET = 1 << 22  # (face, pixel) fragments rasterised at once
_NONE = torch.iinfo(torch.int64).max  # no key, no face


def _camera_frame(vertices: torch.Tensor, T_wc) -> torch.Tensor:
    """The vertices in the camera frame, float64 (V, 3): T_cw = T_wc^-1 on
    the host in float64, applied as products and sums in order."""
    T_cw = torch.from_numpy(np.linalg.inv(np.asarray(T_wc, np.float64))).to(vertices.device)
    v = vertices.to(torch.float64)
    return torch.stack([v[:, 0] * T_cw[j, 0] + v[:, 1] * T_cw[j, 1] + v[:, 2] * T_cw[j, 2] + T_cw[j, 3]
                        for j in range(3)], dim=1)


def _face_colours(vertices, faces, colors, light_dir) -> tuple[torch.Tensor, torch.Tensor]:
    """Each face's flat-shaded colour (F, 3) float32, its base colour (the
    mean of its vertices' colours, else 0.7) times 0.3 + 0.7 |n . light|,
    double-sided (marching-cubes face orientation is arbitrary); and whether
    its normal is defined (F,)."""
    fn = _cross(vertices[faces[:, 1]] - vertices[faces[:, 0]], vertices[faces[:, 2]] - vertices[faces[:, 0]])
    fl = _norm3(fn)
    fn = torch.where((fl > 1e-12)[:, None], fn / fl[:, None], fn).to(torch.float64)
    ld = np.asarray(light_dir, np.float64)
    ld = ld / np.linalg.norm(ld)
    shade = 0.3 + 0.7 * torch.abs(fn[:, 0] * ld[0] + fn[:, 1] * ld[1] + fn[:, 2] * ld[2])
    if colors is None:
        base = torch.full((len(faces), 3), 0.7, dtype=torch.float64, device=faces.device)
    else:
        c = colors.to(torch.float32)[faces]
        # a tensor divisor: the card divides by a host scalar as a product with its reciprocal
        base = (c[:, 0] + c[:, 1] + c[:, 2]) / torch.tensor(3.0, device=faces.device)
    return (base * shade[:, None]).to(torch.float32), fl > 1e-12


def render_mesh(
    vertices: torch.Tensor,  # (V, 3) float32
    faces: torch.Tensor,  # (F, 3) int64
    camera,  # PinholeCamera
    T_wc,  # (4, 4) camera-to-world
    colors: torch.Tensor | None = None,  # (V, 3) in [0, 1]
    light_dir=(0.3, -0.5, -0.8),
) -> torch.Tensor:
    """Z-buffered flat-shaded software rasteriser -> (H, W, 3) float32 image
    on the mesh's device (ref Visualizer.cpp:148 `DrawPhongRendering`)."""
    h, w = camera.height, camera.width
    dev = vertices.device
    faces = faces.to(torch.int64)
    vc = _camera_frame(vertices, T_wc)
    z = vc[:, 2]
    zc = torch.clamp(z, min=1e-6)
    u = vc[:, 0] / zc * camera.fx + camera.cx
    v = vc[:, 1] / zc * camera.fy + camera.cy
    colour, ok_f = _face_colours(vertices, faces, colors, light_dir)

    tu, tv, tz = u[faces], v[faces], z[faces]  # (F, 3) each
    x0 = torch.clamp(torch.floor(tu.amin(1)), 0, w).to(torch.int64)
    x1 = torch.clamp(torch.ceil(tu.amax(1)), -1, w - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(tv.amin(1)), 0, h).to(torch.int64)
    y1 = torch.clamp(torch.ceil(tv.amax(1)), -1, h - 1).to(torch.int64)
    # the barycentric denominator and numerators' coefficients, as the JAX loop writes them
    a0, b0 = tv[:, 1] - tv[:, 2], tu[:, 2] - tu[:, 1]
    a1, b1 = tv[:, 2] - tv[:, 0], tu[:, 0] - tu[:, 2]
    den = a0 * (tu[:, 0] - tu[:, 2]) + b0 * (tv[:, 0] - tv[:, 2])
    live = ok_f & (z[faces] > 1e-6).all(1) & (x1 >= x0) & (y1 >= y0) & (torch.abs(den) >= 1e-12)
    fidx = torch.nonzero(live)[:, 0]
    bw = (x1 - x0 + 1)[fidx]
    n_px = bw * (y1 - y0 + 1)[fidx]
    cum = torch.cumsum(n_px, 0)
    cum_h = cum.cpu().numpy()  # read on the host, as `fidx` is: where the chunks end
    if len(fidx) == 0:
        return torch.zeros((h, w, 3), dtype=torch.float32, device=dev)

    kbuf = torch.full((h * w,), _NONE, dtype=torch.int64, device=dev)
    fragments = []
    s, base = 0, 0
    while s < len(fidx):
        e = max(int(np.searchsorted(cum_h, base + FRAGMENT_BUDGET, side="right")), s + 1)
        total = int(cum_h[e - 1]) - base
        local_face = torch.repeat_interleave(torch.arange(s, e, device=dev), n_px[s:e], output_size=total)
        k = torch.arange(total, device=dev) + base - (cum[local_face] - n_px[local_face])
        f = fidx[local_face]
        xs = (x0[f] + k % bw[local_face]).to(torch.float64)
        ys = (y0[f] + k // bw[local_face]).to(torch.float64)
        dx, dy = xs - tu[f, 2], ys - tv[f, 2]
        l0 = (a0[f] * dx + b0[f] * dy) / den[f]
        l1 = (a1[f] * dx + b1[f] * dy) / den[f]
        l2 = 1 - l0 - l1
        zi = 1.0 / (l0 / tz[f, 0] + l1 / tz[f, 1] + l2 / tz[f, 2])
        keep = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (zi < torch.inf)
        zi = zi[keep]
        z32 = zi.to(torch.float32)
        z64 = z32.to(torch.float64)
        key = 2 * z32.view(torch.int32).to(torch.int64) + (z64 < zi).to(torch.int64) - (z64 > zi).to(torch.int64)
        pix = (ys * w + xs).to(torch.int64)[keep]
        kbuf.scatter_reduce_(0, pix, key, "amin")
        fragments.append((pix, key, z64 <= zi, f[keep]))
        s, base = e, int(cum_h[e - 1])

    first = torch.full((h * w,), _NONE, dtype=torch.int64, device=dev)  # lowest index that rounds down
    last = torch.full((h * w,), -1, dtype=torch.int64, device=dev)  # highest index
    for pix, key, down, f in fragments:
        least = kbuf[pix]
        live = (key == least) | ((least % 2 == 0) & (key == least + 1))
        first.scatter_reduce_(0, pix, torch.where(live & down, f, _NONE), "amin")
        last.scatter_reduce_(0, pix, torch.where(live, f, -1), "amax")
    face = torch.where(first != _NONE, first, last)
    return torch.where((face >= 0)[:, None], colour[torch.clamp(face, min=0)], 0.0).reshape(h, w, 3)


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """A float image in [0, 1] -> uint8 on the host, clipped and truncated
    (x 255), as the JAX package's turntable PNG and GIF frames quantise."""
    return (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()


def save_mesh_png(path: str, vertices, faces, camera, T_wc, colors=None) -> None:
    """`render_mesh` written as an RGB PNG of the camera's size."""
    write_png(path, to_uint8(render_mesh(vertices, faces, camera, T_wc, colors)))


def save_gray_png(path: str, gray) -> None:
    """A gray image as an RGB PNG, scaled from its own minimum (black) to its
    maximum (white) in 256 levels, as matplotlib's `gray` map shows it."""
    g = torch.as_tensor(gray, dtype=torch.float32)
    lo, hi = g.min(), g.max()
    x = (g - lo) / (hi - lo) if float(hi) > float(lo) else torch.zeros_like(g)
    level = torch.clamp(torch.floor(x * 256), 0, 255).to(torch.uint8).cpu().numpy()
    write_png(path, np.repeat(level[..., None], 3, axis=2))


def save_depth_png(path: str, depth, max_depth: float = 4.0) -> None:
    """Depth through the Turbo map as an RGB PNG of the image's size: depth
    / max_depth in float32 picks one of 256 entries as matplotlib's `turbo`
    does (x 256, truncated; 1 and above take the last entry), each quantised
    to uint8 as matplotlib's `bytes=True` does. Pixels without depth
    (<= 0) are white, as the JAX package's figure shows them."""
    d = torch.as_tensor(depth, dtype=torch.float32)
    idx = torch.clamp(torch.floor(d / torch.tensor(max_depth, device=d.device) * 256), 0, 255).to(torch.int64)
    lut = torch.from_numpy((np.asarray(TURBO) * 255).astype(np.uint8)).to(d.device)
    rgb = torch.where((d > 0)[..., None], lut[idx], 255)
    write_png(path, rgb.cpu().numpy().astype(np.uint8))


TRAJECTORY_SIZE = 480  # pixels a side
_ESTIMATE_RGB = (31, 119, 180)  # blue
_GT_RGB = (44, 160, 44)  # green


def _polyline(img: np.ndarray, pts: np.ndarray, rgb, dashed: bool) -> None:
    """Draw the pixel polyline pts (N, 2) into img (H, W, 3), one dot a
    pixel of length; dashed: 6 pixels on, 4 off."""
    for a, b in zip(pts[:-1], pts[1:]):
        n = int(np.ceil(np.abs(b - a).max())) + 1
        t = np.linspace(0.0, 1.0, n)
        p = np.rint(a + t[:, None] * (b - a)).astype(np.int64)
        if dashed:
            p = p[(np.arange(n) % 10) < 6]
        img[p[:, 1], p[:, 0]] = rgb


def save_trajectory_png(path: str, poses, gt=None) -> None:
    """Top-down (x-z) trajectory plot, the estimate solid blue and the
    ground truth dashed green, x to the right and z up, one scale for both
    axes, on a white square image."""
    p = np.asarray(poses)[:, :3, 3][:, [0, 2]]
    tracks = [(p, _ESTIMATE_RGB, False)]
    if gt is not None:
        tracks.append((np.asarray(gt)[:, :3, 3][:, [0, 2]], _GT_RGB, True))
    both = np.concatenate([t for t, _, _ in tracks])
    lo, hi = both.min(0), both.max(0)
    margin = 16
    scale = (TRAJECTORY_SIZE - 1 - 2 * margin) / max(float((hi - lo).max()), 1e-9)
    centre = (lo + hi) / 2
    img = np.full((TRAJECTORY_SIZE, TRAJECTORY_SIZE, 3), 255, np.uint8)
    for t, rgb, dashed in tracks:
        px = (t - centre) * scale + (TRAJECTORY_SIZE - 1) / 2
        px[:, 1] = TRAJECTORY_SIZE - 1 - px[:, 1]  # z up
        _polyline(img, px, rgb, dashed)
    write_png(path, img)
