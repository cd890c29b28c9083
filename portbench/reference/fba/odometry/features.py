"""FAST-9 corners, intensity-centroid orientation and steered BRIEF-256.

Port of `onepiece_tpu/odometry/features.py` (`_fast_response`, `_nms`,
`_blur5_batch`, `detect_and_describe`, `detect_and_describe_batch`). The
JAX package shapes this front end for the TPU: one-hot selector matmuls for
the BRIEF taps, an int8 MXU product, a 4-wide lane-packed patch gather. On
a GPU the natural form is the direct one, so the port:

  - keeps the 16 ring offsets, the 16 rolls and their order, so the FAST
    score sums round as the JAX package's do;
  - selects keypoints with a stable descending sort: among equal scores
    the lowest pixel index comes first, as `lax.top_k` (and, on the CPU,
    `approx_max_k`) returns them;
  - reads each BRIEF bit's two rotated taps directly, from a (30, 256, 2, 2)
    table of tap offsets per angle bin built by the JAX package's rotation
    rule (`_build_brief_selector`);
  - quantises the blurred image as round(x * 127) clipped to [-127, 127]
    (identical to the JAX package for x in [0, 1], where its unclipped int8
    cast agrees; above ~1.004 that cast overflows);
  - takes a bit as the sign of the integer tap difference, packed LSB first
    into 8 words of 32 bits, held as int32.

Frozen copy for the benchmark's reference: the plain version on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FAST_RADIUS = 3
# Bresenham circle of radius 3, the 16 (dx, dy) offsets in the JAX package's order
FAST_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    np.int32,
)

PATCH_RADIUS = 15  # orientation patch (31x31), like ORB
BRIEF_BITS = 256
NUM_ANGLE_BINS = 30  # steered-BRIEF orientation bins (12 degrees)


class Keypoints(NamedTuple):
    uv: torch.Tensor  # (..., K, 2) float32 pixel coords [u, v]
    score: torch.Tensor  # (..., K)
    angle: torch.Tensor  # (..., K) radians
    desc: torch.Tensor  # (..., K, 8) int32: 256 packed bits (the JAX package's uint32 words)
    valid: torch.Tensor  # (..., K) bool


def _brief_pattern(seed: int = 7) -> np.ndarray:
    """(256, 2, 2) int32 point-pair offsets (dy, dx), Gaussian sigma = patch/5,
    clipped to the 31x31 patch (original BRIEF G-II sampling)."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(scale=sigma, size=(BRIEF_BITS, 2, 2))
    return np.clip(np.round(pts), -(PATCH_RADIUS - 2), PATCH_RADIUS - 2).astype(np.int32)


BRIEF_PATTERN = _brief_pattern()


def _brief_taps() -> np.ndarray:
    """(NUM_ANGLE_BINS, 256, 2, 2) int64 tap offsets (ry, rx) of each bit's two
    points rotated by each angle bin, rounded and clipped as the JAX
    package's selector places its ones."""
    taps = np.zeros((NUM_ANGLE_BINS, BRIEF_BITS, 2, 2), np.int64)
    for b in range(NUM_ANGLE_BINS):
        ang = 2.0 * np.pi * b / NUM_ANGLE_BINS
        ca, sa = np.cos(ang), np.sin(ang)
        for s in range(BRIEF_BITS):
            for pt in range(2):
                dy, dx = BRIEF_PATTERN[s, pt]
                rx = int(np.clip(np.round(ca * dx - sa * dy), -PATCH_RADIUS + 1, PATCH_RADIUS - 1))
                ry = int(np.clip(np.round(sa * dx + ca * dy), -PATCH_RADIUS + 1, PATCH_RADIUS - 1))
                taps[b, s, pt] = (ry, rx)
    return taps


BRIEF_TAPS = _brief_taps()

# moment masks of the intensity-centroid orientation, over the 31x31 patch
_ys, _xs = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
_disk = (_xs**2 + _ys**2) <= PATCH_RADIUS * PATCH_RADIUS
_KX = (_xs * _disk).astype(np.int64)
_KY = (_ys * _disk).astype(np.int64)
# the JAX package divides the angle by the jit constant 2*pi/30, which XLA
# evaluates as a multiply by its float32 reciprocal
_INV_BIN = float(np.float32(1.0) / np.float32(2.0 * np.pi / NUM_ANGLE_BINS))
_TABLES = {"kx": _KX.reshape(-1), "ky": _KY.reshape(-1), "taps": BRIEF_TAPS}
_on_device: dict = {}


def _table(name: str, device: torch.device) -> torch.Tensor:
    """A constant table on the device, copied once per device (a copy from
    the host per call would wait for the device)."""
    key = (name, device)
    if key not in _on_device:
        _on_device[key] = torch.from_numpy(_TABLES[name]).to(device)
    return _on_device[key]


def _fast_response(gray: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9/16 corner response map (0 where not a corner), (..., H, W):
    bright and dark arc masks as 16-bit rings, a >=9-run test on them, the
    score the larger of the two arc sums."""
    sb = torch.zeros_like(gray)
    sd = torch.zeros_like(gray)
    xb = torch.zeros(gray.shape, dtype=torch.int64, device=gray.device)
    xd = torch.zeros(gray.shape, dtype=torch.int64, device=gray.device)
    for i, (dx, dy) in enumerate(FAST_OFFSETS.tolist()):
        diff = torch.roll(gray, (-dy, -dx), dims=(-2, -1)) - gray
        sb = sb + torch.clamp(diff - threshold, min=0.0)
        sd = sd + torch.clamp(-diff - threshold, min=0.0)
        xb = xb | ((diff > threshold).to(torch.int64) << i)
        xd = xd | ((diff < -threshold).to(torch.int64) << i)

    def runs9(x):
        x = x | (x << 16)  # the ring twice: circular runs visible from bits 0..15
        r2 = x & (x >> 1)
        r4 = r2 & (r2 >> 2)
        r8 = r4 & (r4 >> 4)
        r9 = r8 & (x >> 8)
        return (r9 & 0xFFFF) != 0

    return torch.where(runs9(xb) | runs9(xd), torch.maximum(sb, sd), 0.0)


def _nms(score: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """(2r+1)^2 non-max suppression as a separable max filter (rows, then
    columns), wrapping at the edges as the JAX package's rolls do."""
    mx = score
    for d in range(1, radius + 1):
        mx = torch.maximum(mx, torch.maximum(torch.roll(score, d, -1), torch.roll(score, -d, -1)))
    m = mx
    for d in range(1, radius + 1):
        m = torch.maximum(m, torch.maximum(torch.roll(mx, d, -2), torch.roll(mx, -d, -2)))
    return torch.where(score >= m, score, 0.0)


def _blur5_batch(imgs: torch.Tensor) -> torch.Tensor:
    """Separable 5x5 binomial blur over (..., H, W) with edge replication,
    rows first, the taps summed in the JAX package's order."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    h, w = imgs.shape[-2:]
    lead = imgs.shape[:-2]
    x = imgs.reshape(-1, 1, h, w)
    p = torch.nn.functional.pad(x, (2, 2, 0, 0), mode="replicate")
    tmp = 0
    for i in range(5):
        tmp = tmp + float(k[i]) * p[..., :, i : i + w]
    p2 = torch.nn.functional.pad(tmp, (0, 0, 2, 2), mode="replicate")
    out = 0
    for i in range(5):
        out = out + float(k[i]) * p2[..., i : i + h, :]
    return out.reshape(*lead, h, w)


def _border_mask(h: int, w: int, device) -> torch.Tensor:
    """Pixels whose FAST ring and 31x31 patch stay inside the image."""
    b = PATCH_RADIUS + 1
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[b : h - b, b : w - b] = True
    return m


def _quantise(imgs: torch.Tensor) -> torch.Tensor:
    """round(x * 127) clipped to [-127, 127], as int32."""
    return torch.clamp(torch.round(imgs * 127.0), -127, 127).to(torch.int32)


def _describe(q: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantised images q (B, H, W) int32 and keypoint pixels (B, K) ->
    (angle (B, K), packed descriptors (B, K, 8) int32).

    A keypoint's moments sum its 31x31 patch against the disk masks, in
    exact integers; its bits read the two taps of its angle bin. Pixels off
    the image read 0 (the JAX package pads its rows with zeros); keypoints
    on the border mask never reach them."""
    b, h, w = q.shape
    k = sx.shape[1]
    r = PATCH_RADIUS
    dev = q.device
    padded = torch.nn.functional.pad(q, (r, r, r, r)).reshape(-1)
    hp, wp = h + 2 * r, w + 2 * r
    # keypoint centres in the padded images (invalid keypoints may sit anywhere)
    cy = torch.clamp(sy, 0, h - 1).to(torch.int64) + r
    cx = torch.clamp(sx, 0, w - 1).to(torch.int64) + r
    centre = (torch.arange(b, device=dev)[:, None] * hp + cy) * wp + cx  # (B, K)
    centre = centre.reshape(-1)
    ys = torch.arange(-r, r + 1, device=dev)
    offs = (ys[:, None] * wp + ys[None, :]).reshape(-1)  # (961,) row-major (dy, dx)
    patch = padded[centre[:, None] + offs[None, :]].to(torch.int64)  # (B*K, 961)
    m10 = (patch * _table("kx", dev)).sum(-1)
    m01 = (patch * _table("ky", dev)).sum(-1)
    angle = torch.atan2(m01.to(torch.float32), m10.to(torch.float32))
    abin = torch.remainder(torch.round(angle * _INV_BIN).to(torch.int64), NUM_ANGLE_BINS)
    taps = _table("taps", dev)[abin]  # (B*K, 256, 2, 2) (ry, rx)
    vals = padded[centre[:, None, None] + taps[..., 0] * wp + taps[..., 1]]  # (B*K, 256, 2)
    bits = (vals[..., 1] - vals[..., 0] > 0).to(torch.int64).reshape(-1, 8, 32)
    words = torch.sum(bits << torch.arange(32, device=dev), dim=-1)  # [0, 2^32)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return angle.reshape(b, k), words.reshape(b, k, 8)


def detect_and_describe_batch(
    grays: torch.Tensor,  # (B, H, W) float32 in [0, 1]
    max_keypoints: int = 1000,
    threshold: float = 0.08,
    nms_radius: int = 2,
) -> Keypoints:
    """FAST-9 + orientation + steered BRIEF-256 over a chunk of frames: the
    `max_keypoints` best NMS'd corners of each frame, lowest pixel index
    first among equal scores; score 0 marks an invalid slot."""
    b, h, w = grays.shape
    resp = _fast_response(grays, threshold)
    resp = torch.where(_border_mask(h, w, grays.device), resp, 0.0)
    resp = _nms(resp, nms_radius)
    score, idx = torch.sort(resp.reshape(b, h * w), dim=-1, descending=True, stable=True)
    score, idx = score[:, :max_keypoints], idx[:, :max_keypoints]
    sy, sx = idx // w, idx % w
    uv = torch.stack([sx.to(torch.float32), sy.to(torch.float32)], dim=-1)
    angle, desc = _describe(_quantise(_blur5_batch(grays)), sx, sy)
    return Keypoints(uv, score, angle, desc, score > 0.0)


def detect_and_describe(
    gray: torch.Tensor,  # (H, W) float32 in [0, 1]
    max_keypoints: int = 1000,
    threshold: float = 0.08,
    nms_radius: int = 2,
) -> Keypoints:
    """One frame of `detect_and_describe_batch` (the JAX package's
    single-frame form computes the same: its blur, top-k and quantisation
    agree with the batched ones)."""
    kp = detect_and_describe_batch(gray[None], max_keypoints, threshold, nms_radius)
    return Keypoints(*(t[0] for t in kp))

