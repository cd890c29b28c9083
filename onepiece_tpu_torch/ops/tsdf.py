"""TSDF voxel-block ops: block keys of a frame and the exact integration oracle.

Port of `onepiece_tpu/ops/tsdf.py`. Conventions:
  - CUBE_SIZE = 8 voxels per block edge; sdf starts at EMPTY_SDF, weight 0
  - the truncated sdf is stored normalised to [-1, 1] (sdf / truncation)
  - running weighted average with per-update weight 1, weight capped
  - a block key packs (coord + 512) into 10 bits per axis; INVALID_KEY
    (2^30, larger than any packed key) fills unused entries
"""

from __future__ import annotations

import numpy as np
import torch

CUBE_SIZE = 8
EMPTY_SDF = 999.0
INVALID_KEY = 1 << 30

# truncation-band sampling offsets along each ray (fractions of truncation)
OFFSET_FRACTIONS = (-1.0, -0.5, 0.0, 0.5, 1.0)


def _recip(x: float) -> float:
    """The float32 reciprocal of a float32 constant, as a Python float."""
    return float(np.float32(1.0) / np.float32(x))


def _pixel_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return v, u


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding, as a fused multiply-add gives it (the
    float64 product of two float32 numbers is exact)."""
    return (a.double() * b.double() + c.double()).float()


def transform_fma(T: torch.Tensor, x, y, z) -> tuple[torch.Tensor, ...]:
    """Rows of T (4, 4) applied to points given by coordinate: the FMA chain
    fma(R2, z, fma(R1, y, R0 * x)) + t, which is how XLA's CPU dot evaluates
    the JAX package's transforms and how the TSDF kernel does (`fmaf`)."""
    return tuple(fma(T[r, 2], z, fma(T[r, 1], y, T[r, 0] * x)) + T[r, 3] for r in range(3))


def voxel_centers_world(block_coords: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """World-space voxel centers for blocks (B, 3) int -> (B, 512, 3) f32,
    voxel (i, j, k) of block c at (c * CUBE + (i, j, k) + 0.5) * voxel_size."""
    n = CUBE_SIZE
    lin = torch.arange(n**3, device=block_coords.device)
    local = torch.stack([lin // (n * n), (lin // n) % n, lin % n], dim=-1)  # x-major
    pos = (block_coords[:, None, :] * n + local[None]).to(torch.float32)
    return (pos + 0.5) * voxel_size


def integrate_blocks(
    sdf: torch.Tensor,  # (B, 512) normalised tsdf
    weight: torch.Tensor,  # (B, 512)
    color: torch.Tensor,  # (B, 512, 3)
    block_coords: torch.Tensor,  # (B, 3) int
    block_active: torch.Tensor,  # (B,) bool
    depth: torch.Tensor,  # (H, W) meters, 0 invalid
    rgb: torch.Tensor,  # (H, W, 3)
    T_cw: torch.Tensor,  # (4, 4) world-to-camera
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
    max_weight: float = 100.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One frame's projective TSDF update of all blocks (the exact oracle):
    nearest-pixel depth lookup, sdf = depth - z_cam, update where
    sdf > -truncation. Returns new (sdf, weight, color)."""
    h, w = depth.shape
    x, y, z = transform_fma(T_cw, *voxel_centers_world(block_coords, voxel_size).unbind(-1))
    zsafe = torch.where(z > 1e-6, z, 1.0)
    ui = torch.round(x / zsafe * fx + cx).to(torch.int32)
    vi = torch.round(y / zsafe * fy + cy).to(torch.int32)
    inb = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (z > 1e-6)
    uic = torch.clamp(ui, 0, w - 1).long()
    vic = torch.clamp(vi, 0, h - 1).long()
    d_px = depth[vic, uic]
    sdf_m = d_px - z
    upd = inb & (d_px > 0) & (sdf_m > -truncation) & block_active[:, None]

    tsdf_new = torch.clamp(sdf_m / truncation, -1.0, 1.0)
    denom = torch.clamp(weight + 1.0, min=1.0)
    w_new = torch.where(upd, torch.clamp(weight + 1.0, max=max_weight), weight)
    sdf_safe = torch.where(weight > 0, sdf, 0.0)
    sdf_out = torch.where(upd, (sdf_safe * weight + tsdf_new) / denom, sdf)
    c_px = rgb[vic, uic]
    c_safe = torch.where(weight[..., None] > 0, color, 0.0)
    c_out = torch.where(
        upd[..., None], (c_safe * weight[..., None] + c_px) / denom[..., None], color
    )
    return sdf_out, w_new, c_out


def touched_block_coords(
    depth: torch.Tensor,
    T_wc: torch.Tensor,  # camera-to-world
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block coords of the points at each OFFSET_FRACTIONS * truncation along
    every pixel's ray. Returns (coords (N*5, 3) int32, valid (N*5,) bool)."""
    h, w = depth.shape
    v, u = _pixel_grid(h, w, depth.device)
    valid = depth > 0
    dirs = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]
    # XLA evaluates the JAX package's division by this constant as a multiply
    # by its float32 reciprocal; doing the same puts points on a block
    # boundary into the same block in both packages
    inv_edge = _recip(voxel_size * CUBE_SIZE)
    offsets = torch.tensor(OFFSET_FRACTIONS, dtype=torch.float32) * truncation
    coords = []
    for off in offsets.tolist():
        # `off` holds a float32 value; adding it as a Python float rounds as
        # the JAX package's float32 add does
        pts_w = (dirs * (depth + off)[..., None]) @ R.T + t
        coords.append(torch.floor(pts_w * inv_edge).to(torch.int32).reshape(-1, 3))
    return torch.cat(coords), valid.reshape(-1).repeat(len(OFFSET_FRACTIONS))


def unique_padded(keys: torch.Tensor, size: int) -> torch.Tensor:
    """Sorted unique keys, truncated or padded with INVALID_KEY to `size`.

    Counterpart of `jnp.unique(size=..., fill_value=INVALID_KEY)`. Built
    from sort + first-occurrence ranks + one scatter, so unlike
    `torch.unique` the host never waits for the number of unique keys."""
    s, _ = torch.sort(keys)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first, dim=0) - 1
    # non-first entries and ranks past `size` go to a spill cell, cut below
    idx = torch.where(first & (rank < size), rank, size)
    out = torch.full((size + 1,), INVALID_KEY, dtype=keys.dtype, device=keys.device)
    out.scatter_(0, idx, s)
    return out[:size]


def touched_block_keys(
    depth: torch.Tensor,
    T_wc: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
    max_blocks: int = 4096,
    stride: int = 4,
) -> torch.Tensor:
    """Unique packed block keys touched by the truncation band, (max_blocks,)
    int32, INVALID_KEY-padded. Pixels are subsampled by `stride`."""
    # the intrinsics of the subsampled grid, rounded as XLA computes the JAX
    # package's division by the constant stride (a float32 reciprocal multiply)
    fx, fy, cx, cy = (float(np.float32(c) * np.float32(_recip(stride))) for c in (fx, fy, cx, cy))
    coords, valid = touched_block_coords(
        depth[::stride, ::stride], T_wc, fx, fy, cx, cy, voxel_size, truncation
    )
    c = torch.clamp(coords + 512, 0, 1023)
    keys = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
    keys = torch.where(valid, keys, INVALID_KEY)
    # cheap pre-dedupe before the sort: consecutive ray offsets of one pixel,
    # and neighbouring pixels of a row, usually land in the same block
    hs = -(-depth.shape[0] // stride)
    ws = -(-depth.shape[1] // stride)
    ko = keys.reshape(len(OFFSET_FRACTIONS), hs, ws)
    dup = torch.zeros_like(ko, dtype=torch.bool)
    dup[1:] = ko[1:] == ko[:-1]
    dup[:, :, 1:] |= ko[:, :, 1:] == ko[:, :, :-1]
    keys = torch.where(dup.reshape(-1), INVALID_KEY, keys)
    return unique_padded(keys, max_blocks)


def pack_block_keys(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int block coords -> packed int32 keys, 10 bits per axis, as
    `touched_block_keys` packs them; coords outside [-512, 511] clamp."""
    c = torch.clamp(coords.to(torch.int32) + 512, 0, 1023)
    return (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]


def unpack_block_keys(keys) -> np.ndarray:
    """Host helper: packed keys -> (N, 3) int64 coords, dropping fill slots."""
    k = np.asarray(keys)
    k = k[k != INVALID_KEY]
    return np.stack([(k >> 20) & 1023, (k >> 10) & 1023, k & 1023], -1).astype(np.int64) - 512


def debug_point_cloud(
    sdf: torch.Tensor,  # (B, 8, 8, 8) raw sdf (truncation-scaled metres)
    weight: torch.Tensor,  # (B, 8, 8, 8)
    block_coords: torch.Tensor,  # (B, 3) int
    voxel_size: float,
    truncation: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Near-surface voxel centres as a debug cloud, on the volume's device:
    every voxel with weight != 0 and |sdf| < truncation, coloured gray by
    |sdf| / truncation. Returns (points (B*512, 3), colors (B*512, 3),
    valid (B*512,))."""
    b = sdf.shape[0]
    centers = voxel_centers_world(block_coords, voxel_size)  # (B, 512, 3)
    s = sdf.reshape(b, -1)
    w = weight.reshape(b, -1)
    valid = (w != 0) & (torch.abs(s) < truncation)
    g = torch.abs(s) / torch.tensor(truncation, dtype=s.dtype, device=s.device)
    return centers.reshape(-1, 3), torch.stack([g, g, g], dim=-1).reshape(-1, 3), valid.reshape(-1)
