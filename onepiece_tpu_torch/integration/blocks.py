"""Voxel-block TSDF volume container. Port of the fields of
`onepiece_tpu/integration/blocks.py:TSDFVolume` that
`FusedDenseFusion.to_volume` fills (meshing and host-side allocation are
not ported yet)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TSDFVolume:
    """Blocks by pool slot: sdf/weight (B, 8, 8, 8), color (B, 8, 8, 8, 3);
    `block_coords[:num_active]` and `slot_of` map slots to block coords."""

    sdf: torch.Tensor
    weight: torch.Tensor
    color: torch.Tensor
    block_coords: np.ndarray  # (capacity, 3) int64
    slot_of: dict[tuple[int, int, int], int]
    num_active: int
    voxel_size: float
    truncation: float
