"""Voxel-block TSDF volume: a device pool + a host block table.

Port of `onepiece_tpu/integration/blocks.py:TSDFVolume`. The voxels live in
the port's channels-first pool `vox` (capacity + 1, 5, 512) [sdf, weight,
r, g, b], the last row a trash row, as `FusedDenseFusion` keeps them; `sdf`,
`weight` and `color` are views of it in the JAX package's layout
((capacity, 8, 8, 8[, 3])). The host keeps a {(bx, by, bz) -> slot} dict
and the coords by slot; blocks take slots in the order they are first seen.

  - `integrate`: a frame's touched block keys on the device, one read of
    them to the host, allocation, then the TSDF kernel (`tsdf_slots.
    integrate_slots`) on the touched rows. (The JAX package integrates
    through `integrate_blocks_matmul`, whose 128-row image window and
    one-hot selection exist for the TPU; the kernel reads the image at each
    voxel's pixel.)
  - `extract_mesh_tensors`: the marching-cubes kernel (`marching_cubes.
    extract_triangles`) over every active block, neighbour slots found on
    the device; `extract_mesh` copies its triangles to the host.
The pool grows by doubling when it fills, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..ops import marching_cubes as mc_ops
from ..ops import tsdf as tsdf_ops
from ..ops import tsdf_slots
from ..utils import tracing

# defaults of the reference (voxel 0.0125 m, truncation 0.1 m)
DEFAULT_VOXEL_SIZE = 0.0125
DEFAULT_TRUNCATION = 0.1


def neighbor_slots_device(block_coords: torch.Tensor) -> torch.Tensor:
    """(N, 3) int coords of blocks at slots 0..N-1 -> (N, 7) int32 slots of
    each block's NEIGHBOR_OFFSETS neighbours (-1 absent), found on the
    coords' device by a binary search of the sorted packed keys."""
    coords = block_coords.to(torch.int32)
    n = coords.shape[0]
    if n == 0:
        return torch.zeros((0, 7), dtype=torch.int32, device=coords.device)
    keys, order = torch.sort(tsdf_ops.pack_block_keys(coords))
    with tracing.sync("mesh_offsets_upload"):
        offsets = torch.from_numpy(mc_ops.NEIGHBOR_OFFSETS).to(coords.device)
    nbr = coords[:, None, :] + offsets
    in_range = ((nbr >= -512) & (nbr <= 511)).all(-1)  # packing would clamp the rest onto real blocks
    nkeys = tsdf_ops.pack_block_keys(nbr)
    pos = torch.clamp(torch.searchsorted(keys, nkeys), max=n - 1)
    found = in_range & (keys[pos] == nkeys)
    return torch.where(found, order[pos], -1).to(torch.int32)


@dataclasses.dataclass
class TSDFVolume:
    """`device` holds the pool ("cuda", the default, runs the kernels; "cpu"
    their plain versions). `vox`, if given, is an existing pool to wrap
    without a copy (its capacity and device win)."""

    voxel_size: float = DEFAULT_VOXEL_SIZE
    truncation: float = DEFAULT_TRUNCATION
    capacity: int = 4096
    max_weight: float = 100.0
    device: str | torch.device = "cuda"
    vox: torch.Tensor | None = dataclasses.field(default=None, repr=False)
    max_blocks: int = 4096  # touched keys a frame's key pass returns; doubles when a frame fills it

    def __post_init__(self):
        if self.vox is None:
            self.device = torch.device(self.device)
            self.vox = tsdf_slots.make_pool(self.capacity, self.device)
        else:
            self.device = self.vox.device
            self.capacity = self.vox.shape[0] - 1
        self.block_coords = np.zeros((self.capacity, 3), np.int64)
        self.slot_of: dict[tuple[int, int, int], int] = {}
        self.num_active = 0
        self.key_saturated_frames = 0  # frames whose touched keys filled max_blocks

    # -- the JAX package's fields, as views of the pool ----------------------

    @property
    def sdf(self) -> torch.Tensor:  # (capacity, 8, 8, 8)
        return tsdf_slots.pool_to_blocks(self.vox)[0]

    @property
    def weight(self) -> torch.Tensor:  # (capacity, 8, 8, 8)
        return tsdf_slots.pool_to_blocks(self.vox)[1]

    @property
    def color(self) -> torch.Tensor:  # (capacity, 8, 8, 8, 3)
        return tsdf_slots.pool_to_blocks(self.vox)[2]

    # -- host bookkeeping -------------------------------------------------

    def _grow(self, needed: int) -> None:
        """Double the capacity until `needed` blocks fit; rows keep their slots."""
        old = self.capacity
        while self.capacity < needed:
            self.capacity *= 2
        vox = tsdf_slots.make_pool(self.capacity, self.device)
        vox[:old] = self.vox[:old]
        self.vox = vox
        bc = np.zeros((self.capacity, 3), np.int64)
        bc[:old] = self.block_coords
        self.block_coords = bc

    def allocate(self, coords: np.ndarray) -> None:
        """Ensure blocks exist for the given (N, 3) integer block coords."""
        new = [t for t in map(tuple, np.asarray(coords, np.int64).tolist()) if t not in self.slot_of]
        new = list(dict.fromkeys(new))  # dedupe, first-seen order
        if not new:
            return
        if self.num_active + len(new) > self.capacity:
            self._grow(self.num_active + len(new))
        for t in new:
            self.slot_of[t] = self.num_active
            self.block_coords[self.num_active] = t
            self.num_active += 1

    def active_coords(self) -> np.ndarray:
        return self.block_coords[: self.num_active]

    # -- per-frame integration -------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def integrate_prepared(self, depth, rgb, T_wc, camera: PinholeCamera, coords: np.ndarray) -> int:
        """Integrate one posed frame into the blocks `coords` (N, 3), already
        on the host (the pipelined path fetched them asynchronously): allocate,
        then one TSDF kernel launch over their rows. `rgb` (H, W, 3) or None
        (colour 0, as the JAX package fuses it). Returns num_active."""
        coords = np.asarray(coords, np.int64).reshape(-1, 3)
        self.allocate(coords)
        depth = self._tensor(depth)
        if rgb is None:
            colour = torch.zeros((3,) + depth.shape, device=self.device)
        else:
            colour = self._tensor(rgb).permute(2, 0, 1)
        img = torch.cat([depth[None], colour])  # (4, H, W) [depth, r, g, b]
        slots = torch.tensor([self.slot_of[t] for t in map(tuple, coords.tolist())], dtype=torch.int32)
        # keys and slots in one host-to-device copy, then the pose
        with tracing.sync("volume_upload", 2):
            ks = torch.stack([tsdf_ops.pack_block_keys(torch.from_numpy(coords)), slots]).to(self.device)
            T_cw = se3.inverse_T(self._tensor(T_wc))
        tsdf_slots.integrate_slots(
            self.vox, ks[0], ks[1], img, T_cw, camera.fx, camera.fy, camera.cx, camera.cy,
            self.voxel_size, self.truncation, self.max_weight,
        )
        return self.num_active

    def integrate(self, depth, rgb, T_wc, camera: PinholeCamera) -> int:
        """Allocate the frame's touched blocks and fuse one posed RGB-D frame
        (`touched_block_keys` at a pixel stride of 4, as the JAX package
        calls it). Returns num_active.

        The key pass returns at most `max_blocks` keys. Where the host's read
        of them shows the cap reached, the frame counts in
        `key_saturated_frames` and the pass is redone at twice the cap (kept
        for later frames) until the keys fit, so no block is dropped. (The
        JAX package caps at 4096 and drops the rest without a word.)"""
        depth = self._tensor(depth)
        with tracing.sync("volume_pose"):
            T = self._tensor(T_wc)
        saturated = False
        while True:
            keys = tsdf_ops.touched_block_keys(
                depth, T, camera.fx, camera.fy, camera.cx, camera.cy, self.voxel_size, self.truncation,
                max_blocks=self.max_blocks,
            )
            with tracing.sync("volume_keys"):
                keys = keys.cpu()
            if int((keys != tsdf_ops.INVALID_KEY).sum()) < self.max_blocks:
                break
            saturated = True
            self.max_blocks *= 2
        self.key_saturated_frames += saturated
        return self.integrate_prepared(depth, rgb, T_wc, camera, tsdf_ops.unpack_block_keys(keys))

    # -- meshing ----------------------------------------------------------

    def _neighbor_slots(self) -> np.ndarray:
        """(num_active, 7) pool slots of each active block's +halo
        neighbours (-1 absent), from the host dict."""
        na = self.num_active
        out = np.full((na, 7), -1, np.int64)
        for i in range(na):
            base = self.block_coords[i]
            for j, off in enumerate(mc_ops.NEIGHBOR_OFFSETS):
                out[i, j] = self.slot_of.get(tuple((base + off).tolist()), -1)
        return out

    def extract_mesh_tensors(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Marching cubes over all active blocks -> (vertices (T, 3, 3),
        colors (T, 3, 3)) float32 tensors on the volume's device: the
        kernel meshes every block in one launch and caps nothing."""
        with tracing.span("meshing.extract"):
            na = self.num_active
            with tracing.sync("mesh_coords_upload"):
                coords = torch.from_numpy(self.block_coords[:na]).to(self.device, torch.int32)
            return mc_ops.extract_triangles(
                self.vox, torch.arange(na, dtype=torch.int32, device=self.device),
                neighbor_slots_device(coords), coords, self.voxel_size,
            )

    def extract_mesh(self, chunk: int = 128, cap_per_block: int = 96) -> tuple[np.ndarray, np.ndarray]:
        """`extract_mesh_tensors` copied to the host as float32 arrays, in the
        JAX package's signature: `chunk` and `cap_per_block` are taken for
        it and unused."""
        del chunk, cap_per_block
        verts, colors = self.extract_mesh_tensors()
        return verts.cpu().numpy(), colors.cpu().numpy()
