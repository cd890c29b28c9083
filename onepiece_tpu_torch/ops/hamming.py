"""Hamming matching of 256-bit binary descriptors.

Port of `onepiece_tpu/ops/hamming.py` (`hamming_table`, `match_descriptors`,
`match_descriptors_windowed`, `mutual_filter`). Descriptors are (..., 8)
int32: the JAX package's uint32 words, bit for bit.

The JAX package builds the whole (N, M) distance table as a +-1 bf16 matmul
on the MXU and reduces it with `top_k` / `argmin`. Here the table is never
written on the card: `hamming_match` (`csrc/hamming.cu`) lists the valid
targets in shared memory and gives each query a warp whose lanes split them,
each keeping a best index, best distance and second distance from XOR +
`__popc`, merged across the lanes by (distance, index). On CPU
tensors the plain versions below run: XOR and a SWAR popcount in int64
(exact), then the same reductions the JAX package makes. Ties go to the
lowest target index, as `lax.top_k` and `argmin` break them, and the second
distance equals the best on a tie (the second entry of the sorted row).
"""

from __future__ import annotations

import torch

from .. import _build

HAMMING_MAX = 256
MASKED = HAMMING_MAX + 1  # distance of a masked target
_ROWS = 256  # query rows per block of the plain version's (rows, M, 8) table


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 entry (SWAR, in int32: the arithmetic shifts'
    sign bits are masked off, and no step overflows)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def hamming_table_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 -> (N, M) int32 distances."""
    out = []
    for s in range(0, a.shape[0], _ROWS):
        x = a[s : s + _ROWS, None, :] ^ b[None]
        out.append(_popcount32(x).sum(-1, dtype=torch.int32))
    if not out:
        return torch.zeros((0, b.shape[0]), dtype=torch.int32, device=a.device)
    return torch.cat(out)


def _window_mask(uv_pred_a, uv_b, window) -> torch.Tensor:
    du = uv_pred_a[:, None, 0] - uv_b[None, :, 0]
    dv = uv_pred_a[:, None, 1] - uv_b[None, :, 1]
    return (torch.abs(du) <= window) & (torch.abs(dv) <= window)


def hamming_match_reference(
    desc_a: torch.Tensor,  # (N, 8) int32
    desc_b: torch.Tensor,  # (M, 8) int32
    valid_b: torch.Tensor,  # (M,) bool
    uv_pred_a: torch.Tensor | None = None,  # (N, 2): window centres in b's image
    uv_b: torch.Tensor | None = None,  # (M, 2)
    window: float = 20.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: per query (best index int64, best distance
    int32, second distance int32) over the targets, a masked target (invalid,
    or outside the window when one is given) at distance 257."""
    d = hamming_table_reference(desc_a, desc_b)
    mask = valid_b[None, :]
    if uv_pred_a is not None:
        mask = mask & _window_mask(uv_pred_a, uv_b, window)
    d = torch.where(mask, d, MASKED)
    # a stable sort keeps equal distances in index order: lowest index first
    srt, order = torch.sort(d, dim=-1, stable=True)
    return order[:, 0], srt[:, 0], srt[:, 1]


def _hamming_match_cuda(desc_a, desc_b, valid_b, uv_pred_a, uv_b, window):
    dev = desc_a.device
    n, m = desc_a.shape[0], desc_b.shape[0]
    _build.require(desc_a, "desc_a", torch.int32, (n, 8), dev, align=16)
    _build.require(desc_b, "desc_b", torch.int32, (m, 8), dev, align=16)
    _build.require(valid_b, "valid_b", torch.bool, (m,), dev)
    windowed = uv_pred_a is not None
    if windowed:
        _build.require(uv_pred_a, "uv_pred_a", torch.float32, (n, 2), dev, align=8)
        _build.require(uv_b, "uv_b", torch.float32, (m, 2), dev, align=8)
    best = torch.empty(n, dtype=torch.int64, device=dev)
    dist = torch.empty((2, n), dtype=torch.int32, device=dev)
    if n == 0:
        return best, dist[0], dist[1]
    err = _build.library().hamming_match(
        desc_a.data_ptr(), desc_b.data_ptr(), valid_b.data_ptr(),
        uv_pred_a.data_ptr() if windowed else None, uv_b.data_ptr() if windowed else None,
        float(window), n, m, best.data_ptr(), dist.data_ptr(), _build.stream_handle(desc_a),
    )
    _build.check(err, _build.HAMMING)
    _build.HAMMING.launches += 1
    return best, dist[0], dist[1]


def hamming_match(desc_a, desc_b, valid_b, uv_pred_a=None, uv_b=None, window: float = 20.0):
    """(best index (N,) int64, best distance (N,) int32, second distance (N,)
    int32): the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors. Needs M >= 2 targets, as the JAX package's `top_k(-d, 2)` does."""
    if desc_a.is_cuda:
        return _hamming_match_cuda(desc_a, desc_b, valid_b, uv_pred_a, uv_b, window)
    if desc_a.device.type == "cpu":
        return hamming_match_reference(desc_a, desc_b, valid_b, uv_pred_a, uv_b, window)
    raise ValueError(f"hamming_match: unsupported device {desc_a.device}")


def _hamming_table_cuda(a, b):
    dev = a.device
    n, m = a.shape[0], b.shape[0]
    _build.require(a, "a", torch.int32, (n, 8), dev, align=16)
    _build.require(b, "b", torch.int32, (m, 8), dev, align=16)
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    if n == 0 or m == 0:
        return out
    err = _build.library().hamming_table(a.data_ptr(), b.data_ptr(), n, m, out.data_ptr(), _build.stream_handle(a))
    _build.check(err, _build.HAMMING)
    _build.HAMMING.launches += 1
    return out


def hamming_table(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 -> (N, M) int32 Hamming distances: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if a.is_cuda:
        return _hamming_table_cuda(a, b)
    if a.device.type == "cpu":
        return hamming_table_reference(a, b)
    raise ValueError(f"hamming_table: unsupported device {a.device}")


def match_descriptors(
    desc_a: torch.Tensor,  # (N, 8) int32
    valid_a: torch.Tensor,  # (N,) bool
    desc_b: torch.Tensor,  # (M, 8) int32
    valid_b: torch.Tensor,  # (M,) bool
    max_distance: int = 64,
    ratio: float = 0.8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best match with Lowe's 2-NN ratio test: (index into b (N,) int64,
    match valid (N,))."""
    best, bd, sd = hamming_match(desc_a, desc_b, valid_b)
    ok = valid_a & (bd <= max_distance) & (bd.to(torch.float32) <= ratio * sd.to(torch.float32))
    return best, ok


def match_descriptors_windowed(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    uv_pred_a: torch.Tensor,  # (N, 2) predicted pixel of a's points in b's image
    uv_b: torch.Tensor,  # (M, 2) keypoint pixels in b
    window: float = 20.0,
    max_distance: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pose-guided re-match: the nearest descriptor among b's keypoints within
    `window` pixels (both axes) of the predicted pixel."""
    best, bd, _ = hamming_match(desc_a, desc_b, valid_b, uv_pred_a, uv_b, window)
    return best, valid_a & (bd <= max_distance)


def mutual_filter(idx_ab: torch.Tensor, ok_ab: torch.Tensor, idx_ba: torch.Tensor) -> torch.Tensor:
    """Keep matches whose target's best match points back (cross-check)."""
    n = idx_ab.shape[0]
    return ok_ab & (idx_ba[idx_ab] == torch.arange(n, device=idx_ab.device))
