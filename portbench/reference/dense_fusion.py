"""The plain reference of the dense fusion configuration, and its control.

`track` works out a scan's poses from its frames alone, as the program's
frame loop does (frame-to-frame Gauss-Newton from a constant-velocity
start, the pose chain). `integrate` fuses the scan's frames into a pool of
its own, keyed by block, at the poses it is given, mirroring the program's
touched-key buffer and its block allocation (`block_hash`). `mesh` runs marching
cubes and the vertex dedup over a pool it is given.

The control (`control_scan`) is this reference computed with every stored
image, point, pool row and mesh vertex rounded through bfloat16 (sums in
float32; the mesh's vertices are merged before they are rounded): the
precision below the float32 that the configuration states. It returns
what the program returns, so the comparison can judge it in the program's
place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import block_hash as H
from . import plain_ops as P


class ScanOut(NamedTuple):
    """What a scan gives its user: poses, the pool, the mesh."""

    poses: torch.Tensor  # (N, 4, 4) world-from-camera, float32
    vox: torch.Tensor  # (R, 5, 512) pool rows [sdf, weight, r, g, b]
    coords: torch.Tensor  # (B, 3) int32 block coords of rows 0..B-1
    verts: torch.Tensor  # (V, 3) deduplicated mesh
    faces: torch.Tensor  # (F, 3) int64
    colors: torch.Tensor  # (V, 3)


def camera(cfg: dict) -> P.Camera:
    c = cfg["camera"]
    return P.Camera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"])


def track(grays, depths, cfg: dict, rnd=P.exact) -> torch.Tensor:
    """(N, 4, 4) poses of a scan, frame 0 at the identity."""
    cam = camera(cfg)
    levels, iters = len(cfg["iters"]), tuple(cfg["iters"])
    eye = torch.eye(4, dtype=torch.float32, device=grays.device)
    prev = P.preprocess_frame(rnd(grays[0]), rnd(depths[0]), cam, levels, rnd)
    T_w, rel, poses = eye, eye, [eye]
    for i in range(1, grays.shape[0]):
        cur = P.preprocess_frame(rnd(grays[i]), rnd(depths[i]), cam, levels, rnd)
        rel = P.dense_tracking(prev, cur, cam, rel, iters, rnd)
        T_w = T_w @ P.inverse_T(rel)
        poses.append(T_w)
        prev = cur
    return torch.stack(poses)


class Pool(NamedTuple):
    """The reference's pool: rows by slot, the blocks' coords by slot."""

    vox: torch.Tensor  # (capacity + 1, 5, 512), the last row trash
    coords: torch.Tensor  # (num_active, 3) int32
    overflow: int  # keys that missed a frame (unresolved claims)


def integrate(depths, rgbs, poses, cfg: dict, rnd=P.exact, counts: list | None = None) -> Pool:
    """Fuse a scan's frames at `poses` into a fresh pool as the program
    allocates it (`block_hash`): per frame the bilateral-filtered depth, the
    touched keys (at most kmax, which doubles after a chunk in which a
    frame from the second on filled it), the claims (12 rounds for the
    first frame, 2 after) and the TSDF update; between chunks the pool's
    growth. `counts`, if given, gets (touched blocks, voxels updated, of
    them from weight 0) per frame."""
    cam = camera(cfg)
    dev = depths.device
    kmax, chunk, capacity = cfg["kmax"], cfg["chunk"], cfg["capacity"]
    vox = P.make_pool(capacity, dev)
    table = H.make_table(cfg["table_size"], capacity, dev)
    saturated = False
    for i in range(depths.shape[0]):
        if i and i % chunk == 0:
            if saturated:
                kmax *= 2
                saturated = False
            grown = H.grow(table, vox, capacity, P.make_pool)
            if grown is not None:
                table, vox, capacity = grown
        d = rnd(P.bilateral_filter(rnd(depths[i])))
        keys = P.touched_block_keys(d, poses[i], cam.fx, cam.fy, cam.cx, cam.cy, cfg["voxel_size"],
                                    cfg["truncation"], kmax, cfg["stride"])
        if i:  # the program records saturation from frame 1 on
            saturated |= bool(keys[-1] != P.INVALID_KEY)
        table, slots = H.insert(table, keys, claim_rounds=H.FRAME_CLAIM_ROUNDS if i else H.INIT_CLAIM_ROUNDS)
        rows = torch.where(slots < 0, vox.shape[0] - 1, slots).to(torch.int32)
        img = torch.cat([d[None], rnd(rgbs[i]).permute(2, 0, 1)])
        upd, fresh = P.integrate_rows(vox, keys, rows, img, P.inverse_T(poses[i]), cam.fx, cam.fy, cam.cx,
                                      cam.cy, cfg["voxel_size"], cfg["truncation"], cfg["max_weight"])
        if rnd is not P.exact:
            live = rows[rows < vox.shape[0] - 1].long()
            vox[live] = rnd(vox[live])
        if counts is not None:
            counts.append((int((keys != P.INVALID_KEY).sum()), upd, fresh))
    na = int(table.num_active)
    return Pool(vox, table.block_coords[:na].clone(), int(table.overflow))


def mesh(vox, coords, voxel_size: float):
    """(verts, faces, colours, triangles per block) of the blocks at rows
    0..B-1 of `vox` with coords `coords`."""
    b = coords.shape[0]
    slots = torch.arange(b, dtype=torch.int32, device=vox.device)
    tv, tc, per_block = P.extract_triangles(vox, slots, P.neighbor_slots(coords), coords, voxel_size)
    v, f, c = P.dedup_triangle_soup(tv, tc)
    return v, f, c, per_block


def control_scan(grays, depths, rgbs, cfg: dict) -> ScanOut:
    """The reference in bfloat16 storage, in the program's place."""
    poses = track(grays, depths, cfg, P.bf16)
    pool = integrate(depths, rgbs, poses, cfg, P.bf16)
    coords = pool.coords
    v, f, c, _ = mesh(pool.vox, coords, cfg["voxel_size"])
    return ScanOut(poses, pool.vox, coords, P.bf16(v), f, P.bf16(c))
