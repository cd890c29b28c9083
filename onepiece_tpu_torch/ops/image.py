"""Image ops of the dense-odometry front end. Port of `onepiece_tpu/ops/image.py`.

Same stencils and coefficients (OpenCV's 5-tap binomial pyrDown filter,
3x3 Sobel), written as slice stencils over a padded image so the sums run
in the same tap order as the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _conv2d_same(img: torch.Tensor, kernel) -> torch.Tensor:
    """Single-channel 2D correlation with edge replication, (H, W) x (kh, kw)."""
    k_np = np.asarray(kernel)
    kh, kw = k_np.shape
    ph, pw = kh // 2, kw // 2
    h, w = img.shape
    # F.pad's replicate mode wants a batched (N, C, H, W) input
    padded = F.pad(img[None, None], (pw, pw, ph, ph), mode="replicate")[0, 0]
    out = torch.zeros_like(img)
    for iy in range(kh):
        for ix in range(kw):
            c = float(k_np[iy, ix])
            if c == 0.0:
                continue
            out = out + c * padded[iy : iy + h, ix : ix + w]
    return out


_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """5x5 binomial (Gaussian) blur, separable."""
    k = _BINOMIAL5
    return _conv2d_same(_conv2d_same(img, k[None, :]), k[:, None])


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """OpenCV-style pyrDown: binomial blur then 2x decimation."""
    return gaussian_blur(img)[::2, ::2]


def build_pyramid(img: torch.Tensor, levels: int) -> tuple[torch.Tensor, ...]:
    """Level 0 is the input; each next level is pyrDown of the previous."""
    out = [img]
    for _ in range(levels - 1):
        out.append(pyr_down(out[-1]))
    return tuple(out)


def sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel (dx, dy), unscaled."""
    return _conv2d_same(img, _SOBEL_X), _conv2d_same(img, _SOBEL_X.T)


def box_sum3(img: torch.Tensor) -> torch.Tensor:
    """3x3 box sum with edge replication (validity-window counting)."""
    return _conv2d_same(img, np.ones((3, 3)))


def scharr(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Scharr gradients (dx, dy), unscaled."""
    k = np.array([[-3.0, 0, 3], [-10, 0, 10], [-3, 0, 3]])
    return _conv2d_same(img, k), _conv2d_same(img, k.T)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 or float -> (H, W) float32 in [0, 255] (BT.601 weights)."""
    rgb = rgb.to(torch.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def depth_to_meters(depth_raw: torch.Tensor, depth_scale: float) -> torch.Tensor:
    """Raw integer depth -> float32 metres; zeros stay zero. The divisor is
    a tensor on the depth's device, so the quotient is numpy's on every
    device (the card divides by a host scalar as a product with its
    reciprocal)."""
    scale = torch.tensor(depth_scale, dtype=torch.float32, device=depth_raw.device)
    return depth_raw.to(torch.float32) / scale


def clip_depth(depth: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """Invalidate (set 0) depths outside [near, far] and non-finite values."""
    ok = torch.isfinite(depth) & (depth >= near) & (depth <= far)
    return torch.where(ok, depth, 0.0)


def bilateral_filter(
    depth: torch.Tensor,
    radius: int = 2,
    sigma_space: float = 2.0,
    sigma_value: float = 0.03,
) -> torch.Tensor:
    """Edge-preserving depth smoothing over a (2r+1)^2 window, skipping
    invalid (0) depths. Pads with ZEROS (unlike `_conv2d_same`), so taps off
    the image count as invalid."""
    h, w = depth.shape
    r = radius
    padded = F.pad(depth, (r, r, r, r))
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    valid_c = depth > 0
    inv2v = 1.0 / (2 * sigma_value**2)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = padded[r + dy : r + dy + h, r + dx : r + dx + w]
            ok = (shifted > 0) & valid_c
            ws = math.exp(-(dx * dx + dy * dy) / (2 * sigma_space**2))
            wv = torch.exp(-((shifted - depth) ** 2) * inv2v)
            w_ = torch.where(ok, ws * wv, 0.0)
            acc = acc + w_ * shifted
            wacc = wacc + w_
    out = torch.where(wacc > 1e-8, acc / torch.clamp(wacc, min=1e-8), depth)
    return torch.where(valid_c, out, 0.0)


def bilinear_sample(
    img: torch.Tensor, uv: torch.Tensor, *, valid_zero: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear interpolation of (H, W) `img` at (..., 2) [u, v] coords.

    Returns (values (...,), in-bounds mask (...,)). With `valid_zero`,
    samples whose 2x2 neighbourhood holds a zero (invalid depth) are masked.
    """
    h, w = img.shape
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = u0.to(torch.int32)
    v0i = v0.to(torch.int32)
    inb = (u0i >= 0) & (u0i < w - 1) & (v0i >= 0) & (v0i < h - 1)
    u0c = torch.clamp(u0i, 0, w - 2).long()
    v0c = torch.clamp(v0i, 0, h - 2).long()
    p00 = img[v0c, u0c]
    p01 = img[v0c, u0c + 1]
    p10 = img[v0c + 1, u0c]
    p11 = img[v0c + 1, u0c + 1]
    val = (
        p00 * (1 - fu) * (1 - fv)
        + p01 * fu * (1 - fv)
        + p10 * (1 - fu) * fv
        + p11 * fu * fv
    )
    if valid_zero:
        inb = inb & (p00 > 0) & (p01 > 0) & (p10 > 0) & (p11 > 0)
    return val, inb
