"""Block-sharded TSDF integration: no collectives.

Port of `onepiece_tpu/parallel/tsdf.py`. The block axis is split into one
contiguous slice per rank (padded to a multiple of the world size with
inactive blocks); the frame and pose are replicated. Integration is
independent per block, so each rank runs `ops/tsdf.integrate_blocks` on its
own blocks and nothing crosses between ranks.
"""

from __future__ import annotations

import torch

from ..ops import tsdf as tsdf_ops
from .comm import ShardGroup


def integrate_blocks_sharded(
    group: ShardGroup,
    sdf: torch.Tensor,  # (Bs, 512) this rank's blocks
    weight: torch.Tensor,
    color: torch.Tensor,  # (Bs, 512, 3)
    block_coords: torch.Tensor,  # (Bs, 3)
    block_active: torch.Tensor,  # (Bs,)
    depth: torch.Tensor,  # (H, W) replicated
    rgb: torch.Tensor,  # (H, W, 3) replicated
    T_cw: torch.Tensor,  # (4, 4) replicated
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`ops/tsdf.integrate_blocks` on this rank's blocks (`group.shard_rows`
    of each block array: padding blocks are inactive); returns their new
    (sdf, weight, color)."""
    del group  # no collective: every block is independent
    return tsdf_ops.integrate_blocks(
        sdf, weight, color, block_coords, block_active, depth, rgb, T_cw,
        fx, fy, cx, cy, voxel_size, truncation,
    )
