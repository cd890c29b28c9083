"""The fused TSDF path on a pool sharded by slot over the ranks.

Port of `onepiece_tpu/parallel/fused.py`. Each rank holds a pool shard of
`cap_local + 1` rows (its own trash row last), global slot g living on rank
g // cap_local at row g % cap_local. The block hash table is replicated:
allocation is deterministic, so every rank derives the same {key -> slot}
map from the same frame (`ops/tsdf.touched_block_keys`, then
`integration/device_hash.insert`) with no collective. Each rank then runs
the TSDF kernel (`ops/tsdf_slots.integrate_slots`) unchanged on its shard,
with every slot outside its range sent to its trash row. `gather_pool` is
one `all_gather`, into global-slot order.

The key pass is the port's repaired one (`integration/blocks.py`): where
the touched keys fill `kmax`, the frame counts as saturated and the pass is
redone at twice the cap until they fit, so no block is dropped. (The JAX
function caps at `kmax` and drops the rest without a word.) The check reads
the key count on the host once per frame; every rank reads the same count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..integration import device_hash as dh
from ..ops import tsdf as tsdf_ops
from ..ops import tsdf_slots
from .comm import ShardGroup


class StepOut(NamedTuple):
    table: dh.BlockHashTable
    kmax: int  # the cap the frame's keys fit in (doubled past a saturated one)
    saturated: bool  # the frame's keys filled the cap it was called with


def make_sharded_pool(group: ShardGroup, cap_local: int) -> torch.Tensor:
    """This rank's (cap_local + 1, 5, 512) shard: sdf EMPTY, weight 0, last row trash."""
    return tsdf_slots.make_pool(cap_local, group.device)


def touched_keys_repaired(depth_f, T_w, fx, fy, cx, cy, voxel_size, truncation, kmax, stride):
    """(keys, kmax, saturated): the frame's touched block keys at the first
    cap, doubled until they fit (one host read per pass)."""
    saturated = False
    while True:
        keys = tsdf_ops.touched_block_keys(depth_f, T_w, fx, fy, cx, cy, voxel_size, truncation,
                                           max_blocks=kmax, stride=stride)
        if int((keys != tsdf_ops.INVALID_KEY).sum()) < kmax:
            return keys, kmax, saturated
        saturated = True
        kmax *= 2


def fused_tsdf_step_sharded(
    group: ShardGroup,
    vox_l: torch.Tensor,  # (cap_local + 1, 5, 512) this rank's shard, updated in place
    table: dh.BlockHashTable,  # replicated
    depth_f: torch.Tensor,  # (H, W) filtered metric depth
    gray: torch.Tensor,  # (H, W)
    T_w: torch.Tensor,  # (4, 4) world-from-camera
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
    kmax: int = 4096,
    stride: int = 6,
    claim_rounds: int = 6,
) -> StepOut:
    """One frame's allocation (replicated) and integration (this rank's
    slots) into the sharded pool; no collective."""
    cap_local = vox_l.shape[0] - 1
    if table.block_coords.shape[0] < cap_local * group.world:
        raise ValueError(f"table capacity {table.block_coords.shape[0]} < {cap_local} x {group.world} pool rows")
    keys, kmax, saturated = touched_keys_repaired(
        depth_f, T_w, fx, fy, cx, cy, voxel_size, truncation, kmax, stride)
    table, slots = dh.insert(table, keys, claim_rounds=claim_rounds)
    local = slots - group.rank * cap_local
    local = torch.where((slots >= 0) & (local >= 0) & (local < cap_local), local, cap_local).to(torch.int32)
    tsdf_slots.integrate_slots(vox_l, keys, local, torch.stack([depth_f, gray]), se3.inverse_T(T_w),
                               fx, fy, cx, cy, voxel_size, truncation)
    return StepOut(table, kmax, saturated)


def gather_pool(group: ShardGroup, vox_l: torch.Tensor) -> torch.Tensor:
    """The whole (cap_total + 1, 5, 512) pool in global-slot order, on every
    rank (one `all_gather`); its last row is rank 0's trash row."""
    shards = group.all_gather(vox_l)  # (world, cap_local + 1, 5, 512)
    return torch.cat([shards[:, :-1].reshape((-1,) + vox_l.shape[1:]), shards[0, -1:]])
