"""Device-resident voxel-block hash table. Port of
`onepiece_tpu/integration/device_hash.py` in plain PyTorch.

Open addressing with linear probing over a power-of-2 table of packed
30-bit block keys. Inserting a frame's unique keys is a vectorised lookup
over all probe positions, then a fixed number of claim rounds: each new key
targets the first empty cell of its probe window, a scatter-min picks one
winner per cell (the smallest key), and losers retry next round. Slots go
to winners in key order (a cumsum rank), so the slots match the JAX
package's exactly.

Out-of-range writes that JAX drops (`mode="drop"`) go to one extra spill
cell appended to each buffer for the scatter and cut off after it. The
claim rounds always run (the JAX package skips them with `lax.cond` when no
key is new); branching on that in Python would make the host wait for the
device every frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.tsdf import INVALID_KEY


class BlockHashTable(NamedTuple):
    table_keys: torch.Tensor  # (S,) int32, INVALID_KEY = empty
    table_slots: torch.Tensor  # (S,) int32, pool slot of the key at this cell
    block_coords: torch.Tensor  # (B, 3) int32 coords by pool slot
    num_active: torch.Tensor  # () int32
    overflow: torch.Tensor  # () int32, keys dropped (table/probe/pool exhaustion)


def make_table(table_size: int, capacity: int, device) -> BlockHashTable:
    if table_size & (table_size - 1):
        raise ValueError(f"table_size must be a power of 2, got {table_size}")
    i32 = dict(dtype=torch.int32, device=device)
    return BlockHashTable(
        table_keys=torch.full((table_size,), INVALID_KEY, **i32),
        table_slots=torch.zeros((table_size,), **i32),
        block_coords=torch.zeros((capacity, 3), **i32),
        num_active=torch.zeros((), **i32),
        overflow=torch.zeros((), **i32),
    )


def _hash_keys(keys: torch.Tensor, mask: int) -> torch.Tensor:
    """Multiplicative hash onto the table. The JAX package multiplies in
    uint32; int64 with an explicit 32-bit wrap gives the same cells."""
    h = (keys.to(torch.int64) * 2654435761) & 0xFFFFFFFF
    h = h ^ (h >> 15)
    return (h & mask).to(torch.int32)


def unpack_keys(keys: torch.Tensor) -> torch.Tensor:
    """Packed 30-bit keys -> (N, 3) int32 block coords."""
    return torch.stack([(keys >> 20) & 1023, (keys >> 10) & 1023, keys & 1023], dim=-1) - 512


def _scatter_set(buf: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """buf[idx] = values, where idx == len(buf) means drop."""
    ext = torch.cat([buf, buf[:1]])
    ext[idx] = values.to(buf.dtype)
    return ext[: buf.shape[0]]


def _first_true(mask: torch.Tensor, pos_all: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(any, cell of the first True) along each key's probe window."""
    j = torch.argmax(mask.to(torch.uint8), dim=1)  # first maximum
    return mask.any(dim=1), torch.gather(pos_all, 1, j[:, None])[:, 0]


def _claim(tk, keys, pending, pos_all):
    """One claim round: pending keys scatter-min into the first currently
    empty cell of their window. Returns (table_keys, cell, claimed)."""
    size = tk.shape[0]
    has_empty, pos = _first_true(tk[pos_all] == INVALID_KEY, pos_all)
    attempt = pending & has_empty
    ext = torch.cat([tk, tk.new_full((1,), INVALID_KEY)])
    ext.scatter_reduce_(0, torch.where(attempt, pos, size), keys, reduce="amin")
    tk = ext[:size]
    return tk, pos, attempt & (tk[pos] == keys)


def _probe_window(keys: torch.Tensor, size: int, max_probes: int) -> torch.Tensor:
    base = _hash_keys(keys, size - 1).to(torch.int64)
    probe = torch.arange(max_probes, dtype=torch.int64, device=keys.device)
    return (base[:, None] + probe[None, :]) & (size - 1)  # (K, P)


def insert(
    table: BlockHashTable,
    keys: torch.Tensor,
    max_probes: int = 16,
    claim_rounds: int = 6,
) -> tuple[BlockHashTable, torch.Tensor]:
    """Insert unique INVALID_KEY-padded keys (K,) int32; allocate pool slots
    for unseen ones. Returns (new table, slots (K,) int32), slot -1 for
    padding and dropped keys. Dropped keys count in `overflow`."""
    tk, ts, bc, na, ov = table
    size = tk.shape[0]
    cap = bc.shape[0]
    valid = keys != INVALID_KEY
    pos_all = _probe_window(keys, size, max_probes)

    # lookup: in steady state nearly every touched block already exists
    any_hit, hit_pos = _first_true(tk[pos_all] == keys[:, None], pos_all)
    slots = torch.where(valid & any_hit, ts[hit_pos], -1)
    pending = valid & ~any_hit

    coords = unpack_keys(keys)
    for _ in range(claim_rounds):
        tk, pos, claimed = _claim(tk, keys, pending, pos_all)
        new_slot = na + torch.cumsum(claimed.to(torch.int32), dim=0) - 1
        fits = claimed & (new_slot < cap)
        # a claim that no longer fits the pool keeps its cell (another key
        # may probe past it) but records slot -1; counted as overflow
        ts = _scatter_set(ts, torch.where(claimed, pos, size), torch.where(fits, new_slot, -1))
        bc = _scatter_set(bc, torch.where(fits, new_slot, cap), coords)
        na = (na + fits.sum()).to(torch.int32)
        slots = torch.where(claimed, ts[pos], slots)
        pending = pending & ~claimed
    dropped = (valid & (slots < 0)).sum()
    return BlockHashTable(tk, ts, bc, na, (ov + dropped).to(torch.int32)), slots.to(torch.int32)


def insert_at(
    table: BlockHashTable,
    keys: torch.Tensor,
    slots: torch.Tensor,
    max_probes: int = 16,
    claim_rounds: int = 12,
) -> BlockHashTable:
    """Insert unique keys with caller-assigned pool slots (table rebuild).
    num_active counts the keys that won a cell; the rest go to overflow."""
    tk, ts, bc, _, ov = table
    size = tk.shape[0]
    cap = bc.shape[0]
    valid = keys != INVALID_KEY
    pos_all = _probe_window(keys, size, max_probes)
    pending = valid
    for _ in range(claim_rounds):
        tk, pos, claimed = _claim(tk, keys, pending, pos_all)
        ts = _scatter_set(ts, torch.where(claimed, pos, size), slots)
        pending = pending & ~claimed
    claimed_ok = valid & ~pending
    bc = _scatter_set(bc, torch.where(claimed_ok, slots.to(torch.int64), cap), unpack_keys(keys))
    na = claimed_ok.sum().to(torch.int32)
    return BlockHashTable(tk, ts, bc, na, (ov + pending.sum()).to(torch.int32))


def lookup(table: BlockHashTable, keys: torch.Tensor, max_probes: int = 16) -> torch.Tensor:
    """Pool slots for packed keys, -1 if absent. (K,) int32 -> (K,) int32."""
    tk, ts = table.table_keys, table.table_slots
    size = tk.shape[0]
    pos = _hash_keys(keys, size - 1).to(torch.int64)
    pending = keys != INVALID_KEY
    slots = torch.full(keys.shape, -1, dtype=torch.int32, device=keys.device)
    for _ in range(max_probes):
        cur = tk[pos]
        hit = pending & (cur == keys)
        slots = torch.where(hit, ts[pos], slots)
        pending = pending & ~hit & (cur != INVALID_KEY)
        pos = (pos + 1) & (size - 1)
    return slots
