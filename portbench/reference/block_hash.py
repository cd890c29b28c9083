"""The program's block allocation, frozen: a copy of the port's plain
PyTorch block hash (`onepiece_tpu_torch/integration/device_hash.py`:
open addressing with linear probing, a bounded number of scatter-min claim
rounds, slots in key order) and of the growth `FusedDenseFusion.maybe_grow`
makes between chunks (the pool doubles past 85 % occupancy, the table is
rebuilt at double size once its load would pass one half). A key whose
claim is not resolved within the rounds misses that frame, in the program
and here alike."""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_KEY = 1 << 30
INIT_CLAIM_ROUNDS = 12
FRAME_CLAIM_ROUNDS = 2
GROW_THRESHOLD = 0.85


class Table(NamedTuple):
    table_keys: torch.Tensor
    table_slots: torch.Tensor
    block_coords: torch.Tensor
    num_active: torch.Tensor
    overflow: torch.Tensor


def make_table(table_size: int, capacity: int, device) -> Table:
    i32 = dict(dtype=torch.int32, device=device)
    return Table(torch.full((table_size,), INVALID_KEY, **i32), torch.zeros((table_size,), **i32),
                 torch.zeros((capacity, 3), **i32), torch.zeros((), **i32), torch.zeros((), **i32))


def _hash_keys(keys: torch.Tensor, mask: int) -> torch.Tensor:
    h = (keys.to(torch.int64) * 2654435761) & 0xFFFFFFFF
    h = h ^ (h >> 15)
    return (h & mask).to(torch.int32)


def unpack_keys(keys: torch.Tensor) -> torch.Tensor:
    return torch.stack([(keys >> 20) & 1023, (keys >> 10) & 1023, keys & 1023], dim=-1) - 512


def _scatter_set(buf, idx, values):
    ext = torch.cat([buf, buf[:1]])
    ext[idx] = values.to(buf.dtype)
    return ext[: buf.shape[0]]


def _first_true(mask, pos_all):
    j = torch.argmax(mask.to(torch.uint8), dim=1)
    return mask.any(dim=1), torch.gather(pos_all, 1, j[:, None])[:, 0]


def _claim(tk, keys, pending, pos_all):
    size = tk.shape[0]
    has_empty, pos = _first_true(tk[pos_all] == INVALID_KEY, pos_all)
    attempt = pending & has_empty
    ext = torch.cat([tk, tk.new_full((1,), INVALID_KEY)])
    ext.scatter_reduce_(0, torch.where(attempt, pos, size), keys, reduce="amin")
    tk = ext[:size]
    return tk, pos, attempt & (tk[pos] == keys)


def _probe_window(keys, size: int, max_probes: int):
    base = _hash_keys(keys, size - 1).to(torch.int64)
    probe = torch.arange(max_probes, dtype=torch.int64, device=keys.device)
    return (base[:, None] + probe[None, :]) & (size - 1)


def insert(table: Table, keys, max_probes: int = 16, claim_rounds: int = 6):
    tk, ts, bc, na, ov = table
    size = tk.shape[0]
    cap = bc.shape[0]
    valid = keys != INVALID_KEY
    pos_all = _probe_window(keys, size, max_probes)
    any_hit, hit_pos = _first_true(tk[pos_all] == keys[:, None], pos_all)
    slots = torch.where(valid & any_hit, ts[hit_pos], -1)
    pending = valid & ~any_hit
    coords = unpack_keys(keys)
    for _ in range(claim_rounds):
        tk, pos, claimed = _claim(tk, keys, pending, pos_all)
        new_slot = na + torch.cumsum(claimed.to(torch.int32), dim=0) - 1
        fits = claimed & (new_slot < cap)
        ts = _scatter_set(ts, torch.where(claimed, pos, size), torch.where(fits, new_slot, -1))
        bc = _scatter_set(bc, torch.where(fits, new_slot, cap), coords)
        na = (na + fits.sum()).to(torch.int32)
        slots = torch.where(claimed, ts[pos], slots)
        pending = pending & ~claimed
    dropped = (valid & (slots < 0)).sum()
    return Table(tk, ts, bc, na, (ov + dropped).to(torch.int32)), slots.to(torch.int32)


def insert_at(table: Table, keys, slots, max_probes: int = 16, claim_rounds: int = 12) -> Table:
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
    return Table(tk, ts, bc, na, (ov + pending.sum()).to(torch.int32))


def grow(table: Table, vox: torch.Tensor, capacity: int, make_pool):
    """The pool and table after `maybe_grow`'s growth step, or None where
    the occupancy stays under the threshold: (table, vox, capacity)."""
    na = int(table.num_active)
    if na <= GROW_THRESHOLD * capacity:
        return None
    dev = vox.device
    new_cap = capacity * 2
    grown = torch.cat([vox[:capacity], make_pool(capacity, dev)[:capacity], vox[capacity:]])
    bc = torch.zeros((new_cap, 3), dtype=torch.int32, device=dev)
    bc[:capacity] = table.block_coords
    tbl = table._replace(block_coords=bc)
    if new_cap > tbl.table_keys.shape[0] // 2:
        c = torch.clamp(bc + 512, 0, 1023)
        packed = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
        slot_ids = torch.arange(new_cap, dtype=torch.int32, device=dev)
        keys = torch.where(slot_ids < na, packed, INVALID_KEY)
        new_tbl = insert_at(make_table(tbl.table_keys.shape[0] * 2, new_cap, dev), keys, slot_ids)
        tbl = new_tbl._replace(overflow=table.overflow + new_tbl.overflow)
    return tbl, grown, new_cap
