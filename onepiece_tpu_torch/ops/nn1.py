"""Exact 1-nearest-neighbour of 3-d points, the correspondence search of ICP.

Port of `onepiece_tpu/ops/knn_pallas.py:nn1_pallas`. For each query point:
the index and squared distance of the nearest valid reference point, with
d2 = (dx*dx + dy*dy) + dz*dz and d = q - r in float32; ties go to the lowest
index; a query with no valid reference gets (0, 1e30).

`nn1` launches the hand-written CUDA kernel (`csrc/nn1.cu`) on CUDA tensors
and runs `nn1_reference`, its plain version, on CPU tensors. Both evaluate
the same expression in the same order (the kernel is built without FMA
contraction), so on the card they agree bit for bit.
"""

from __future__ import annotations

import torch

from .. import _build

LARGE = 1e30
_TILE = 2048  # query rows per (tile, M) block of the plain version
_CHUNK = 1024  # references per chunk of the kernel's grid (`kChunk` in csrc/nn1.cu)


def nn1_reference(
    query: torch.Tensor,  # (N, 3) float32
    ref: torch.Tensor,  # (M, 3) float32
    ref_valid: torch.Tensor,  # (M,) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (idx (N,) int32, d2 (N,) float32)."""
    n = query.shape[0]
    idx = torch.zeros(n, dtype=torch.int32, device=query.device)
    d2 = torch.full((n,), LARGE, dtype=torch.float32, device=query.device)
    if ref.shape[0] == 0:
        return idx, d2
    for s in range(0, n, _TILE):
        q = query[s : s + _TILE]
        # in place, one rounding per operation: d = (dx*dx + dy*dy) + dz*dz
        d = q[:, None, 0] - ref[None, :, 0]
        d.mul_(d)
        dy = q[:, None, 1] - ref[None, :, 1]
        d.add_(dy.mul_(dy))
        dz = torch.sub(q[:, None, 2], ref[None, :, 2], out=dy)
        d.add_(dz.mul_(dz))
        # invalid references (and NaN distances) never win; argmin returns
        # the first index of the minimum, as the kernel's strict `<` does
        d.nan_to_num_(nan=torch.inf).masked_fill_(~ref_valid[None, :], torch.inf)
        arg = torch.argmin(d, dim=1)
        best = torch.gather(d, 1, arg[:, None])[:, 0]
        found = best < LARGE  # the kernel starts from (1e30, 0)
        idx[s : s + _TILE] = torch.where(found, arg, 0).to(torch.int32)
        d2[s : s + _TILE] = torch.where(found, best, LARGE)
    return idx, d2


def _nn1_cuda(query, ref, ref_valid) -> tuple[torch.Tensor, torch.Tensor]:
    dev = query.device
    n, m = query.shape[0], ref.shape[0]
    _build.require(query, "query", torch.float32, (n, 3), dev)
    _build.require(ref, "ref", torch.float32, (m, 3), dev)
    _build.require(ref_valid, "ref_valid", torch.bool, (m,), dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return idx, d2
    chunks = -(-m // _CHUNK)
    part_d2 = torch.empty((chunks, n), dtype=torch.float32, device=dev)  # per-chunk minima
    part_idx = torch.empty((chunks, n), dtype=torch.int32, device=dev)
    err = _build.library().nn1(
        query.data_ptr(), ref.data_ptr(), ref_valid.data_ptr(), n, m,
        idx.data_ptr(), d2.data_ptr(), part_d2.data_ptr(), part_idx.data_ptr(), chunks,
        _build.stream_handle(query),
    )
    _build.check(err, _build.NN1)
    _build.NN1.launches += 1
    return idx, d2


def nn1(
    query: torch.Tensor, ref: torch.Tensor, ref_valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx (N,) int32, d2 (N,) float32): the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if query.is_cuda:
        return _nn1_cuda(query, ref, ref_valid)
    if query.device.type == "cpu":
        return nn1_reference(query, ref, ref_valid)
    raise ValueError(f"nn1: unsupported device {query.device}")
