"""Bytes and operations of one extraction of a scan's pool, as
`chip_smoke.mc_bytes` counts them, from the reference's triangles per
block over the program's pool."""

import torch

from ..reference import plain_ops as P

BYTES_PER_BLOCK = 32 + 512 * 8  # its slot, 7 neighbour slots, the row's sdf and weight
BYTES_PER_MESHED_BLOCK = 12  # its coords, read where a triangle is written
BYTES_PER_COLOUR_VOXEL = 12  # r, g, b of a voxel at a corner of a block with a triangle
BYTES_PER_TRIANGLE = 72  # 3 vertices and 3 colours of 3 float32
OPS_PER_VOXEL = 32
OPS_PER_TRIANGLE = 99


def count(cfg, mix, out, counts):
    if out is None or out.coords.shape[0] == 0:
        return None
    b = out.coords.shape[0]
    slots = torch.arange(b, dtype=torch.int32, device=out.vox.device)
    nbr = P.neighbor_slots(out.coords)
    _, _, per_block = P.extract_triangles(out.vox, slots, nbr, out.coords, cfg["voxel_size"])
    meshed = per_block > 0
    need = torch.zeros((out.vox.shape[0], 8, 8, 8), dtype=torch.bool, device=out.vox.device)
    need[slots[meshed].long()] = True
    for k, off in enumerate(P.NEIGHBOR_OFFSETS.tolist()):
        rows = nbr[meshed, k]
        need[(rows[rows >= 0].long(),) + tuple(0 if o else slice(None) for o in off)] = True
    tris = int(per_block.sum())
    n_bytes = (b * BYTES_PER_BLOCK + int(need.sum()) * BYTES_PER_COLOUR_VOXEL
               + int(meshed.sum()) * BYTES_PER_MESHED_BLOCK + tris * BYTES_PER_TRIANGLE)
    return dict(bytes=n_bytes, ops=OPS_PER_VOXEL * 512 * b + OPS_PER_TRIANGLE * tris)
