"""TSDF integration into the rows of a voxel-block pool, in place.

Port of `onepiece_tpu/ops/tsdf_pallas.py`. The pool is channels-first
`(B + 1, 5, 512)` float32 with channels [sdf, weight, r, g, b]; row B is a
trash row that dropped keys point at. `integrate_slots` runs the
hand-written CUDA kernel (`csrc/tsdf_integrate.cu`) on CUDA tensors and
`integrate_slots_reference` on CPU tensors. Both update `vox` in place.

The image is channels-first float32, in one of two forms: `(2, H, W)`
[depth, gray], with gray written to r, g and b, or `(4, H, W)` [depth, r,
g, b]. (The JAX package's bf16 hi/lo depth split and bf16 rgb packing exist
only for the TPU's selection matmuls; both versions here gather the f32
image at each voxel's pixel, as the exact oracle `ops/tsdf.py:
integrate_blocks` does.)
"""

from __future__ import annotations

import torch

from .. import _build
from .tsdf import CUBE_SIZE, EMPTY_SDF, INVALID_KEY, transform_fma

N_VOX = CUBE_SIZE**3  # 512
IMAGE_CHANNELS = (2, 4)  # [depth, gray] or [depth, r, g, b]


def make_pool(capacity: int, device) -> torch.Tensor:
    """Fresh (capacity + 1, 5, 512) pool: sdf EMPTY, weight 0, last row trash."""
    vox = torch.zeros((capacity + 1, 5, N_VOX), dtype=torch.float32, device=device)
    vox[:, 0, :] = EMPTY_SDF
    return vox


def pool_to_blocks(vox: torch.Tensor):
    """(B + 1, 5, 512) -> (sdf, weight, color) in the (B, 8, 8, 8[, 3]) layout."""
    n = CUBE_SIZE
    b = vox.shape[0] - 1
    body = vox[:b]
    sdf = body[:, 0].reshape(b, n, n, n)
    weight = body[:, 1].reshape(b, n, n, n)
    color = torch.movedim(body[:, 2:5], 1, -1).reshape(b, n, n, n, 3)
    return sdf, weight, color


def integrate_slots_reference(
    vox: torch.Tensor,  # (B + 1, 5, 512) f32
    keys: torch.Tensor,  # (K,) int32 packed block keys
    slots: torch.Tensor,  # (K,) int32 pool rows in [0, B]; others change nothing
    img: torch.Tensor,  # (2, H, W) f32 [depth, gray] or (4, H, W) [depth, r, g, b]
    T_cw: torch.Tensor,  # (4, 4) f32 world-to-camera
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
    max_weight: float = 100.0,
) -> torch.Tensor:
    """Plain PyTorch version: gather the K rows, update, write them back.

    Runs the kernel's arithmetic in the kernel's operation order, with the
    voxel-to-camera transform as the same FMA chain (`transform_fma`)."""
    n = CUBE_SIZE
    n_img, h, w = img.shape
    lin = torch.arange(N_VOX, device=vox.device)
    ii, jj, kk = lin // (n * n), (lin // n) % n, lin % n
    k = keys[:, None]
    bx = ((k >> 20) & 1023) - 512
    by = ((k >> 10) & 1023) - 512
    bz = (k & 1023) - 512
    xw = ((bx * n + ii).to(torch.float32) + 0.5) * voxel_size
    yw = ((by * n + jj).to(torch.float32) + 0.5) * voxel_size
    zw = ((bz * n + kk).to(torch.float32) + 0.5) * voxel_size
    xc, yc, zc = transform_fma(T_cw, xw, yw, zw)
    zsafe = torch.where(zc > 1e-6, zc, 1.0)
    ui = torch.round(xc / zsafe * fx + cx).to(torch.int32)
    vi = torch.round(yc / zsafe * fy + cy).to(torch.int32)
    inb = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (zc > 1e-6)
    pix = torch.clamp(vi, 0, h - 1).long() * w + torch.clamp(ui, 0, w - 1).long()
    d = img[0].reshape(-1)[pix]
    # colour at the voxel's pixel, channel by channel; gray: r = g = b
    cols = [img[c].reshape(-1)[pix] for c in range(1, n_img)]
    if n_img == 2:
        cols = cols * 3
    sdf_m = d - zc
    in_pool = (slots >= 0) & (slots < vox.shape[0])
    upd = inb & (d > 0) & (sdf_m > -truncation) & (k != INVALID_KEY) & in_pool[:, None]

    rows = torch.where(in_pool, slots, vox.shape[0] - 1).long()
    old = vox[rows]  # (K, 5, 512)
    w_old = old[:, 1]
    denom = torch.clamp(w_old + 1.0, min=1.0)
    tsdf_new = torch.clamp(sdf_m / truncation, -1.0, 1.0)
    has = w_old > 0
    new = torch.empty_like(old)
    new[:, 0] = torch.where(upd, (torch.where(has, old[:, 0], 0.0) * w_old + tsdf_new) / denom, old[:, 0])
    new[:, 1] = torch.where(upd, torch.clamp(w_old + 1.0, max=max_weight), w_old)
    for c, c_px in enumerate(cols, start=2):
        c_safe = torch.where(has, old[:, c], 0.0)
        new[:, c] = torch.where(upd, (c_safe * w_old + c_px) / denom, old[:, c])
    # padding keys and slots outside the pool share the trash row with
    # dropped keys: its content is garbage by design, whichever write lands last
    vox[rows] = new
    return vox


def _integrate_slots_cuda(
    vox, keys, slots, img, T_cw, fx, fy, cx, cy, voxel_size, truncation, max_weight
) -> torch.Tensor:
    dev = vox.device
    req = _build.require
    req(vox, "vox", torch.float32, (None, 5, N_VOX), dev)
    req(keys, "keys", torch.int32, (None,), dev)
    req(slots, "slots", torch.int32, keys.shape, dev)
    req(img, "img", torch.float32, (None, None, None), dev)
    req(T_cw, "T_cw", torch.float32, (4, 4), dev)
    if keys.shape[0] == 0:  # nothing to integrate: no launch
        return vox
    n_img, h, w = img.shape
    err = _build.library().tsdf_integrate(
        vox.data_ptr(), keys.data_ptr(), slots.data_ptr(), keys.shape[0], vox.shape[0],
        img.data_ptr(), n_img, h, w, T_cw.data_ptr(), fx, fy, cx, cy,
        voxel_size, truncation, max_weight, _build.stream_handle(vox),
    )
    _build.check(err, _build.TSDF_INTEGRATE)
    _build.TSDF_INTEGRATE.launches += 1
    return vox


def integrate_slots(
    vox: torch.Tensor,
    keys: torch.Tensor,
    slots: torch.Tensor,
    img: torch.Tensor,
    T_cw: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
    max_weight: float = 100.0,
) -> torch.Tensor:
    """In-place TSDF update of `vox` at `slots` for one frame; returns `vox`.

    `img` is (2, H, W) float32 [depth, gray] or (4, H, W) [depth, r, g, b];
    any other channel count or dtype raises ValueError. The CUDA kernel on
    CUDA tensors, the plain version on CPU tensors. Entries with key
    INVALID_KEY are padding and change nothing; so do entries whose slot
    lies outside [0, B] (the kernel cannot raise on them without a host
    sync, so neither version does)."""
    if img.dim() != 3 or img.shape[0] not in IMAGE_CHANNELS or img.dtype != torch.float32:
        raise ValueError(
            f"img: shape {tuple(img.shape)}, dtype {img.dtype}; expected (2, H, W) [depth, gray] "
            "or (4, H, W) [depth, r, g, b] float32")
    args = (vox, keys, slots, img, T_cw, fx, fy, cx, cy, voxel_size, truncation, max_weight)
    if vox.is_cuda:
        return _integrate_slots_cuda(*args)
    if vox.device.type == "cpu":
        return integrate_slots_reference(*args)
    raise ValueError(f"integrate_slots: unsupported device {vox.device}")
