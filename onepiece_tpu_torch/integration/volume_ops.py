"""TSDF volume serialisation, merging, and rigid transformation.

Port of `onepiece_tpu/integration/volume_ops.py`:
  - save/load: an npz of the active blocks (block_coords, sdf, weight, color
    in the JAX layout, voxel_size, truncation, max_weight), the JAX
    package's format, so a volume saved by either package loads in the other;
  - merge: voxel-wise weighted average of two volumes;
  - transform: resample a volume under a rigid transform, trilinear or
    nearest, each new voxel centre looked up in the old volume's sorted
    block keys (`torch.searchsorted`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tsdf import CUBE_SIZE, EMPTY_SDF, pack_block_keys, transform_fma, voxel_centers_world
from .blocks import TSDFVolume


def save_volume(vol: TSDFVolume, path: str) -> None:
    n = vol.num_active
    np.savez_compressed(
        path,
        block_coords=vol.block_coords[:n],
        sdf=vol.sdf[:n].cpu().numpy(),
        weight=vol.weight[:n].cpu().numpy(),
        color=vol.color[:n].cpu().numpy(),
        voxel_size=vol.voxel_size,
        truncation=vol.truncation,
        max_weight=vol.max_weight,
    )


def _power_of_two_capacity(n: int) -> int:
    cap = 1
    while cap < max(n, 16):
        cap *= 2
    return cap


def load_volume(path: str, device="cuda") -> TSDFVolume:
    data = np.load(path)
    n = len(data["block_coords"])
    vol = TSDFVolume(
        voxel_size=float(data["voxel_size"]),
        truncation=float(data["truncation"]),
        capacity=_power_of_two_capacity(n),
        max_weight=float(data["max_weight"]),
        device=device,
    )
    vol.allocate(data["block_coords"])
    _set_blocks(vol, n, *(torch.from_numpy(np.asarray(data[k], np.float32)) for k in ("sdf", "weight", "color")))
    return vol


def _set_blocks(vol: TSDFVolume, n: int, sdf, weight, color) -> None:
    """Write blocks 0..n-1 of the pool from JAX-layout sdf / weight (n, 8, 8,
    8) and color (n, 8, 8, 8, 3)."""
    vol.vox[:n, 0] = sdf.reshape(n, -1).to(vol.device)
    vol.vox[:n, 1] = weight.reshape(n, -1).to(vol.device)
    vol.vox[:n, 2:5] = color.reshape(n, -1, 3).movedim(-1, 1).to(vol.device)


def merge_volumes(a: TSDFVolume, b: TSDFVolume) -> TSDFVolume:
    """Weighted-average merge of b into a copy of a (on a's device)."""
    if abs(a.voxel_size - b.voxel_size) >= 1e-9:
        raise ValueError(f"voxel sizes must match: {a.voxel_size} and {b.voxel_size}")
    out = TSDFVolume(a.voxel_size, a.truncation, a.capacity, a.max_weight, device=a.device)
    out.allocate(a.active_coords())
    out.allocate(b.active_coords())
    # accumulate a's and b's blocks into out's slot order (out's pool starts empty)
    for vol in (a, b):
        na = vol.num_active
        if na == 0:
            continue
        idx = torch.tensor([out.slot_of[tuple(c)] for c in vol.active_coords().tolist()], device=out.device)
        src = vol.vox[:na].to(out.device)
        w_new = src[:, 1]
        sdf_v = torch.where(w_new > 0, src[:, 0], 0.0)
        old = out.vox[idx]
        w_old = old[:, 1]
        w_tot = w_old + w_new
        safe = torch.clamp(w_tot, min=1e-9)
        sdf_old = torch.where(w_old > 0, old[:, 0], 0.0)
        merged = torch.empty_like(old)
        merged[:, 0] = torch.where(w_tot > 0, (sdf_old * w_old + sdf_v * w_new) / safe, EMPTY_SDF)
        merged[:, 1] = torch.clamp(w_tot, max=out.max_weight)
        merged[:, 2:5] = (old[:, 2:5] * w_old[:, None] + src[:, 2:5] * w_new[:, None]) / safe[:, None]
        out.vox[idx] = merged
    return out


def transform_volume(vol: TSDFVolume, T, nearest: bool = False) -> TSDFVolume:
    """Resample `vol` under rigid transform T (new = T applied to old
    points), trilinear or nearest, into a new volume on vol's device."""
    T = np.asarray(T, np.float32)
    dev = vol.device
    n_old = vol.num_active
    if n_old == 0:
        return TSDFVolume(vol.voxel_size, vol.truncation, vol.capacity, vol.max_weight, device=dev)
    block_edge = vol.voxel_size * CUBE_SIZE

    # 1. allocate new blocks covering the transformed old block corners
    old_coords = vol.active_coords().astype(np.float64)
    corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)])
    pts = (old_coords[:, None, :] + corners[None]) * block_edge  # (B, 8, 3)
    new_pts = pts @ T[:3, :3].T + T[:3, 3]
    lo = np.floor(new_pts.min(axis=1) / block_edge).astype(np.int64)
    hi = np.floor(new_pts.max(axis=1) / block_edge).astype(np.int64)
    new_blocks = set()
    for l, h in zip(lo, hi):
        for x in range(l[0], h[0] + 1):
            for y in range(l[1], h[1] + 1):
                for z in range(l[2], h[2] + 1):
                    new_blocks.add((x, y, z))
    new_coords = np.array(sorted(new_blocks), np.int64)
    out = TSDFVolume(vol.voxel_size, vol.truncation, vol.capacity, vol.max_weight, device=dev)
    out.allocate(new_coords)
    nb = out.num_active

    # 2. sorted key table of the old volume (the JAX package's `_key_of` is
    # this packing: out-of-range coords clamp, and so can only match boundary
    # blocks, which stay weight-gated)
    keys_sorted, order = torch.sort(pack_block_keys(torch.from_numpy(vol.active_coords()).to(dev)))
    slot_sorted = order.to(torch.int64)
    sdf_flat, w_flat = vol.vox[:n_old, 0], vol.vox[:n_old, 1]  # (n_old, 512)
    c_flat = vol.vox[:n_old, 2:5].movedim(1, -1)  # (n_old, 512, 3)

    Tinv = torch.from_numpy(np.linalg.inv(T).astype(np.float32)).to(dev)
    centers = voxel_centers_world(torch.from_numpy(out.active_coords()).to(dev), vol.voxel_size)  # (nb, 512, 3)
    p_old = torch.stack(transform_fma(Tinv, *centers.unbind(-1)), -1)

    # trilinear (or nearest) sample of the old volume at the world points
    g = p_old / vol.voxel_size - 0.5  # continuous voxel-centre grid coords
    base = (torch.round(g) if nearest else torch.floor(g)).to(torch.int32)
    frac = g - base
    acc_s = acc_c = acc_w = wsum = 0.0
    corner_range = (0,) if nearest else (0, 1)
    for dx in corner_range:
        for dy in corner_range:
            for dz in corner_range:
                vc = base + torch.tensor([dx, dy, dz], dtype=torch.int32, device=dev)
                wgt = 1.0 if nearest else (
                    torch.abs((1 - dx) - frac[..., 0])
                    * torch.abs((1 - dy) - frac[..., 1])
                    * torch.abs((1 - dz) - frac[..., 2])
                )
                bcoord = torch.div(vc, CUBE_SIZE, rounding_mode="floor")
                local = vc - bcoord * CUBE_SIZE
                key = pack_block_keys(bcoord)
                pos = torch.clamp(torch.searchsorted(keys_sorted, key), 0, n_old - 1)
                found = keys_sorted[pos] == key
                slot = slot_sorted[pos]
                li = ((local[..., 0] * CUBE_SIZE + local[..., 1]) * CUBE_SIZE + local[..., 2]).long()
                s = sdf_flat[slot, li]
                w = w_flat[slot, li]
                c = c_flat[slot, li]
                wf = torch.where(found & (w > 0), wgt, 0.0)
                acc_s = acc_s + s * wf
                acc_c = acc_c + c * wf[..., None]
                acc_w = acc_w + w * wf
                wsum = wsum + wf
    safe = torch.clamp(wsum, min=1e-9)
    n = CUBE_SIZE
    _set_blocks(
        out, nb,
        torch.where(wsum > 0.99, acc_s / safe, EMPTY_SDF).reshape(nb, n, n, n),
        torch.where(wsum > 0.99, acc_w / safe, 0.0).reshape(nb, n, n, n),
        (acc_c / safe[..., None]).reshape(nb, n, n, n, 3),
    )
    return out
