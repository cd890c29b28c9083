"""The C++ reference's binary cube format for TSDF volumes.

Port of `onepiece_tpu/io/ref_tsdf.py`, over the port's
`integration/blocks.py:TSDFVolume`. The format (32-bit little-endian float
words, the reference's CubeHandler ReadFromFile / WriteToFile):

  word 0      : the cube count, stored as a uint32 bit pattern in the
                float slot
  per cube    : its block coordinates x, y, z as floats, then a 6-word run
                [voxel index, sdf, weight, r, g, b] for every voxel with
                |sdf| < 1 and weight != 0, then a -2.0 terminator
  voxel index : x + 8 y + 64 z (x fastest); the pool's rows hold
                64 x + 8 y + z (z fastest), and the two are permuted here

sdf is truncation-normalised ([-1, 1]) and colours are [0, 1] floats in
both systems. The files equal the JAX package's byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..integration.blocks import TSDFVolume
from ..ops.tsdf import CUBE_SIZE

N = CUBE_SIZE
NV = N**3
TERMINATOR = -2.0

_x, _y, _z = np.meshgrid(np.arange(N), np.arange(N), np.arange(N), indexing="ij")
_REF_OF_POOL = (_x + N * _y + N * N * _z).reshape(-1)  # pool index (64 x + 8 y + z) -> reference index
_POOL_OF_REF = np.empty(NV, np.int64)
_POOL_OF_REF[_REF_OF_POOL] = np.arange(NV)


def write_ref_tsdf(path: str, vol: TSDFVolume) -> None:
    """Write the volume's active blocks, in slot order, in the reference's format."""
    na = vol.num_active
    rows = vol.vox[:na].cpu().numpy()  # (na, 5, 512): sdf, weight, r, g, b
    keep = (np.abs(rows[:, 0]) < 1.0) & (rows[:, 1] != 0.0)
    counts = keep.sum(1)
    sizes = 4 + 6 * counts.astype(np.int64)  # block b's words: 3 coordinates, 6 a kept voxel, the terminator
    starts = 1 + np.cumsum(sizes) - sizes
    words = np.empty(1 + int(sizes.sum()), np.float32)
    words[:1].view(np.uint32)[0] = np.uint32(na)
    words[starts[:, None] + np.arange(3)] = vol.block_coords[:na].astype(np.float32)
    words[starts + 3 + 6 * counts] = TERMINATOR
    b, v = np.nonzero(keep)  # by block, then pool index: the reference's run order
    rank = np.arange(len(b)) - np.repeat(np.cumsum(counts) - counts, counts)  # the run's place in its block
    at = starts[b] + 3 + 6 * rank
    runs = np.stack([_REF_OF_POOL[v].astype(np.float32), *(rows[b, c, v] for c in range(5))], 1)
    words[at[:, None] + np.arange(6)] = runs
    words.astype("<f4").tofile(path)


def read_ref_tsdf(path: str, voxel_size: float = 0.0125, truncation: float = 0.1, device="cuda") -> TSDFVolume:
    """Read a reference-format cube file into a TSDFVolume on `device`;
    block i of the file takes slot i, voxels the file leaves out keep the
    empty pool's values."""
    buf = np.fromfile(path, dtype="<f4")
    count = int(buf[:1].view(np.uint32)[0])
    cap = 1 << max(count - 1, 0).bit_length()
    vol = TSDFVolume(voxel_size=voxel_size, truncation=truncation, capacity=cap, device=device)
    coords = np.zeros((count, 3), np.int64)
    run_at = []
    ptr = 1
    for b in range(count):
        coords[b] = buf[ptr : ptr + 3].astype(np.int64)
        ptr += 3
        # the first word of each run is a voxel index >= 0; the terminator ends the block
        ends = np.flatnonzero(buf[ptr : ptr + 6 * (NV + 1) : 6] == TERMINATOR)
        if not len(ends):
            raise ValueError(f"{path}: cube {b} has no terminator within {NV} runs")
        run_at.append(ptr + 6 * np.arange(ends[0]))
        ptr += 6 * int(ends[0]) + 1
    vol.allocate(coords)
    if len(vol.slot_of) != count:
        raise ValueError(f"{path}: {count} cubes but {len(vol.slot_of)} distinct block coordinates")
    n_runs = [len(r) for r in run_at]
    if sum(n_runs):
        runs = buf[np.concatenate(run_at)[:, None] + np.arange(6)]
        block = np.repeat(np.arange(count), n_runs)
        voxel = _POOL_OF_REF[runs[:, 0].astype(np.int64)]
        rows = vol.vox[:count].cpu().numpy()
        rows[block[:, None], np.arange(5), voxel[:, None]] = runs[:, 1:]
        vol.vox[:count] = torch.from_numpy(rows).to(vol.device)
    return vol
