"""Marching cubes and block migration on the slot-sharded TSDF pool.

Port of `onepiece_tpu/parallel/mc.py`, over the shards of `parallel/fused`
(rank r holds global slots [r cap_local, (r + 1) cap_local) and its trash
row) and the replicated hash table.

  1. Halo (`extract_mesh_sharded`). Meshing a block reads the +1 corner layer
     of its 7 neighbour blocks (NEIGHBOR_OFFSETS), and a neighbour may live
     on any rank. Each rank finds its active blocks' neighbour slots in the
     replicated table, and the shards circulate around the ring: `world - 1`
     `ring_shift`s, each rank taking the rows it wants from the shard that is
     visiting (`_ring_gather_rows`). Only the rows up to the last active
     slot of any shard travel. The fetched rows are appended to the local
     rows, the (B, 7) neighbour slots are remapped into that extended pool,
     and the marching-cubes kernel (`ops/marching_cubes.extract_triangles`)
     runs on it unchanged. The kernel caps no block's triangles, so the JAX
     function's `cap_per_block` (96) has no counterpart: nothing is dropped.
     Each rank meshes its active slots in slot order, so the ranks'
     triangles, concatenated in rank order, come in global-slot order:
     the order of the unsharded extraction.
  2. Migration (`reshard_blocks`). A replicated plan sends every active block
     to the rank a Fibonacci hash of its key picks (`_spatial_owner`), at the
     rank it holds there in old-slot order, and rebuilds the table with
     `insert_at`; the rows move with ONE `all_to_all`, each row crossing
     once. Blocks past a destination's capacity are dropped and counted in
     the table's `overflow`.
"""

from __future__ import annotations

import torch

from ..integration import device_hash as dh
from ..ops import marching_cubes as mc_ops
from ..ops import tsdf as tsdf_ops
from ..ops import tsdf_slots
from ..ops.tsdf import INVALID_KEY
from .comm import ShardGroup

ROW = 5 * tsdf_slots.N_VOX  # floats of one pool row


pack_coords = tsdf_ops.pack_block_keys  # (..., 3) block coords -> packed keys, the JAX module's name


def _active_mask(table: dh.BlockHashTable, gslots: torch.Tensor) -> torch.Tensor:
    """A slot is active iff its recorded coords look the slot back up: true
    for insert order and for the layout `reshard_blocks` leaves."""
    back = dh.lookup(table, pack_coords(table.block_coords[gslots.long()]))
    return back == gslots


def _neighbor_slots_device(table: dh.BlockHashTable, coords: torch.Tensor) -> torch.Tensor:
    """(B, 3) block coords -> (B, 7) global slots of their neighbours (-1 absent)."""
    off = torch.from_numpy(mc_ops.NEIGHBOR_OFFSETS).to(coords.device)
    keys = pack_coords(coords[:, None, :] + off).reshape(-1)
    return dh.lookup(table, keys).reshape(coords.shape[0], 7)


def _ring_gather_rows(group: ShardGroup, local_rows: torch.Tensor, want: torch.Tensor,
                      cap_local: int) -> torch.Tensor:
    """Rows of arbitrary GLOBAL slots `want` (M,) (-1 absent: zeros), through
    `world - 1` ring shifts of the shards. `local_rows` (n, R) is this rank's
    rows 0..n-1 (n the same on every rank); a row past n reads zeros."""
    r, n = group.rank, local_rows.shape[0]
    want = want.long()
    want_dev = torch.where(want >= 0, want // cap_local, -1)
    want_loc = torch.where(want >= 0, want % cap_local, 0)
    out = local_rows.new_zeros((want.shape[0], local_rows.shape[1]))
    circ = local_rows
    for s in range(group.world):
        if s:
            circ = group.ring_shift(circ)
        take = (want_dev == (r - s) % group.world) & (want_loc < n)  # the owner of the visiting shard
        out[take] = circ[want_loc[take]]
    return out


def _used_rows(table: dh.BlockHashTable, world: int, cap_local: int) -> int:
    """1 + the largest local row of an active block on any rank (from the
    replicated table: the same on every rank; one host read)."""
    gslots = torch.arange(cap_local * world, dtype=torch.int32, device=table.table_keys.device)
    active = _active_mask(table, gslots).reshape(world, cap_local)
    last = torch.where(active, torch.arange(1, cap_local + 1, device=active.device), 0)
    return int(last.max())


def local_blocks(table: dh.BlockHashTable, lo: int, cap_local: int):
    """The active blocks of global slots [lo, lo + cap_local): (local slots
    (B,) int32 in slot order, coords (B, 3), neighbour global slots (B, 7))."""
    gslots = lo + torch.arange(cap_local, dtype=torch.int32, device=table.table_keys.device)
    local_slots = torch.nonzero(_active_mask(table, gslots))[:, 0].to(torch.int32)
    coords = table.block_coords[(lo + local_slots).long()]
    return local_slots, coords, _neighbor_slots_device(table, coords)


def halo_slots(nbr: torch.Tensor, lo: int, cap_local: int) -> torch.Tensor:
    """The sorted global slots of the neighbour rows held by other ranks."""
    remote = (nbr >= 0) & ((nbr < lo) | (nbr >= lo + cap_local))
    return torch.unique(nbr[remote])


def extended_pool(vox_l: torch.Tensor, halo: torch.Tensor, want: torch.Tensor, nbr: torch.Tensor, lo: int):
    """The local rows with the halo rows `halo` (M, 5, 512) of the global
    slots `want` (M,) appended, and the neighbour slots `nbr` (B, 7) remapped
    into that pool (-1 stays absent): (pool, nbr_ext int32)."""
    cap_local = vox_l.shape[0] - 1
    is_local = (nbr >= lo) & (nbr < lo + cap_local)
    halo_row = cap_local + 1 + torch.searchsorted(want, nbr.contiguous())
    nbr_ext = torch.where(is_local, nbr - lo, torch.where(nbr >= 0, halo_row, -1)).to(torch.int32)
    return torch.cat([vox_l, halo]), nbr_ext.contiguous()


def extract_mesh_sharded(
    group: ShardGroup,
    vox_l: torch.Tensor,  # (cap_local + 1, 5, 512) this rank's shard
    table: dh.BlockHashTable,  # replicated
    voxel_size: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's triangles: (verts (T, 3, 3), colors (T, 3, 3)) of its
    active blocks in slot order, halos fetched around the ring."""
    cap_local = vox_l.shape[0] - 1
    lo = group.rank * cap_local
    local_slots, coords, nbr = local_blocks(table, lo, cap_local)
    want = halo_slots(nbr, lo, cap_local)
    used = _used_rows(table, group.world, cap_local)
    halo = _ring_gather_rows(group, vox_l[:used].reshape(used, ROW), want, cap_local)
    ext, nbr_ext = extended_pool(vox_l, halo.reshape(-1, 5, tsdf_slots.N_VOX), want, nbr, lo)
    return mc_ops.extract_triangles(ext, local_slots, nbr_ext, coords.contiguous(), voxel_size)


def gather_triangles(group: ShardGroup, verts: torch.Tensor, colors: torch.Tensor):
    """Every rank's triangles, concatenated in rank order, on every rank
    (two `all_gather`s: the counts, then the padded triangles)."""
    counts = group.all_gather(torch.tensor([verts.shape[0]], device=verts.device)).reshape(-1).tolist()
    m = max(counts)
    pad = torch.zeros((m - verts.shape[0], 2, 3, 3), dtype=verts.dtype, device=verts.device)
    both = group.all_gather(torch.cat([torch.stack([verts, colors], 1), pad]))
    both = torch.cat([both[r, :c] for r, c in enumerate(counts)])
    return both[:, 0], both[:, 1]


def _spatial_owner(keys: torch.Tensor, world: int) -> torch.Tensor:
    """Destination rank of each packed key: Fibonacci hash, uint32 arithmetic
    in int64 with an explicit 32-bit wrap."""
    h = (keys.to(torch.int64) * 2654435761) & 0xFFFFFFFF
    h = h ^ (h >> 15)
    return (h % world).to(torch.int64)


def reshard_blocks(
    group: ShardGroup,
    vox_l: torch.Tensor,  # (cap_local + 1, 5, 512) this rank's shard
    table: dh.BlockHashTable,  # replicated
) -> tuple[torch.Tensor, dh.BlockHashTable]:
    """Move every active block to `_spatial_owner(key)`'s shard. Returns
    (this rank's new shard, the new replicated table)."""
    world, r = group.world, group.rank
    cap_local = vox_l.shape[0] - 1
    cap_total = cap_local * world
    dev = vox_l.device

    # ---- the replicated plan ------------------------------------------------
    gslots = torch.arange(cap_total, dtype=torch.int32, device=dev)
    active = _active_mask(table, gslots)
    keys_all = torch.where(active, pack_coords(table.block_coords[:cap_total]), INVALID_KEY)
    dest = torch.where(active, _spatial_owner(keys_all, world), world)  # world = none
    src = gslots.long() // cap_local
    onehot = dest[:, None] == torch.arange(world, device=dev)  # (cap_total, world)
    # rank of each block among the active blocks with its destination, by old slot
    new_loc = torch.gather(torch.cumsum(onehot.to(torch.int64), 0) - 1, 1, dest.clamp(max=world - 1)[:, None])[:, 0]
    fits = active & (new_loc < cap_local)
    # rank within its (source, destination) send group: new_loc less the
    # blocks for the same destination on earlier sources
    cnt = onehot.reshape(world, cap_local, world).sum(1).T  # (dest, src)
    offs = torch.cumsum(cnt, 1) - cnt
    send_rank = new_loc - offs[dest.clamp(max=world - 1), src]
    new_gslot = torch.where(fits, dest * cap_local + new_loc, -1).to(torch.int32)
    new_table = dh.make_table(table.table_keys.shape[0], cap_total, dev)
    new_table = dh.insert_at(new_table, torch.where(fits, keys_all, INVALID_KEY), new_gslot)
    new_table = new_table._replace(overflow=(new_table.overflow + (active & ~fits).sum()).to(torch.int32))

    # ---- the data: one all_to_all ----------------------------------------------
    per_pair = int(cnt.max())  # the most rows one rank sends another
    mine = slice(r * cap_local, (r + 1) * cap_local)
    send = vox_l.new_zeros((world * per_pair + 1, ROW))  # the last row takes what is not sent
    idx = torch.where(fits[mine], dest[mine] * per_pair + send_rank[mine], world * per_pair)
    send[idx] = vox_l[:cap_local].reshape(cap_local, ROW)
    recv = group.all_to_all(send[:-1].reshape(world, per_pair, ROW)).reshape(world * per_pair, ROW)
    to_me = fits & (dest == r)
    new = tsdf_slots.make_pool(cap_local, dev)
    new.reshape(cap_local + 1, ROW)[new_loc[to_me]] = recv[src[to_me] * per_pair + send_rank[to_me]]
    return new, new_table
