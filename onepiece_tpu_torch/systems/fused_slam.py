"""Device-resident dense SLAM: track + allocate + fuse, no host syncs per frame.

Port of `onepiece_tpu/systems/fused_slam.py`. One frame step:

    1. preprocess_frame     pyramids + XYZ backprojection
    2. dense_tracking       multi-scale Gauss-Newton (one kernel launch per step)
    3. pose chain           T_w_cur = T_w_prev @ inv(T_ts)
    4. bilateral_filter     pre-fusion depth smoothing
    5. touched_block_keys   unique packed keys in the truncation band
    6. device_hash.insert   pool slots, allocating new blocks
    7. integrate_slots      in-place TSDF update of the pool (TSDF kernel)

Everything stays on the system's device; the host launches work and reads
nothing back until `finalize` (and the properties that report counters).
The pool is updated in place and the hash table is replaced each frame;
nothing is donated, so the JAX package's defensive copies of donated
buffers have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..integration import device_hash as dh
from ..integration.blocks import TSDFVolume
from ..odometry import dense
from ..ops import tsdf as tsdf_ops
from ..ops import tsdf_slots
from ..ops.image import bilateral_filter

MAX_WEIGHT = 100.0
# frame 0's bulk insert into an empty table sees real claim contention; in
# steady state two rounds resolve all same-cell races in practice
INIT_CLAIM_ROUNDS = 12
FRAME_CLAIM_ROUNDS = 2


class FusedState(NamedTuple):
    pyr: dense.FramePyramid  # previous frame's pyramid
    T_w: torch.Tensor  # (4, 4) world-from-previous-camera
    rel: torch.Tensor  # (4, 4) last relative pose (constant-velocity init)
    table: dh.BlockHashTable
    vox: torch.Tensor  # (capacity + 1, 5, 512) pool; last row trash


class FrameOut(NamedTuple):
    T_w: torch.Tensor
    rmse: torch.Tensor
    num_inliers: torch.Tensor
    keys_saturated: torch.Tensor  # () bool: the touched-key buffer hit kmax


def _integrate(
    vox, table, depth_f, gray, rgb, T_w, camera, voxel_size, truncation, kmax, stride,
    claim_rounds,
):
    """Allocate the frame's touched blocks and fuse the frame into the pool
    (in place), colour from `rgb` (H, W, 3) or, if it is None, from gray.
    Returns (table, keys_saturated)."""
    keys = tsdf_ops.touched_block_keys(
        depth_f, T_w, camera.fx, camera.fy, camera.cx, camera.cy,
        voxel_size, truncation, max_blocks=kmax, stride=stride,
    )
    # keys are sorted with INVALID_KEY (the largest) as padding: a real key
    # in the last entry means the buffer filled and keys may have been
    # dropped (they retry on later frames) — surfaced, not silent
    saturated = keys[-1] != tsdf_ops.INVALID_KEY
    table, slots = dh.insert(table, keys, claim_rounds=claim_rounds)
    trash = vox.shape[0] - 1
    slots = torch.where(slots < 0, trash, slots).to(torch.int32)
    T_cw = se3.inverse_T(T_w)
    # the kernel's channels-first image: [depth, gray] or [depth, r, g, b]
    img = torch.stack([depth_f, gray]) if rgb is None else torch.cat([depth_f[None], rgb.permute(2, 0, 1)])
    tsdf_slots.integrate_slots(
        vox, keys, slots, img, T_cw,
        camera.fx, camera.fy, camera.cx, camera.cy, voxel_size, truncation, MAX_WEIGHT,
    )
    return table, saturated


def _frame_body(
    state: FusedState,
    gray: torch.Tensor,
    depth: torch.Tensor,
    rgb: torch.Tensor | None,
    camera: PinholeCamera,
    voxel_size: float,
    truncation: float,
    kmax: int,
    stride: int,
    iters: tuple[int, ...],
) -> tuple[FusedState, FrameOut]:
    pyr = dense.preprocess_frame(gray, depth, camera)  # tracking reads gray only
    res = dense.dense_tracking(state.pyr, pyr, camera, init_T=state.rel, iters=iters)
    T_w = dense.chain_pose(state.T_w, res.T_ts)
    table, saturated = _integrate(
        state.vox, state.table, bilateral_filter(depth), gray, rgb, T_w, camera,
        voxel_size, truncation, kmax, stride, FRAME_CLAIM_ROUNDS,
    )
    return (
        FusedState(pyr, T_w, res.T_ts, table, state.vox),
        FrameOut(T_w, res.rmse, res.num_inliers, saturated),
    )


def state_from_numpy(state_np, device) -> FusedState:
    """A FusedState from the JAX package's FusedState with numpy leaves
    (e.g. `jax.tree.map(np.asarray, state)`): pyramid, poses, hash table
    and pool, on `device`. The counterpart of loading weights: a run can
    start from the JAX package's state after frame k. Leaves are copied:
    the pool is updated in place and must not alias the caller's arrays."""

    def t(x):
        return torch.tensor(np.asarray(x), device=device)

    pyr = dense.FramePyramid(*(tuple(t(a) for a in field) for field in state_np.pyr))
    table = dh.BlockHashTable(*(t(a) for a in state_np.table))
    return FusedState(pyr, t(state_np.T_w), t(state_np.rel), table, t(state_np.vox))


@dataclasses.dataclass
class FusedDenseFusion:
    """Host loop: dense VO + TSDF fusion with zero per-frame host syncs.

    Frame-to-frame tracking with a constant-velocity initial pose, every
    frame integrated. `device` says where every tensor of the run lives:
    "cuda" (the default) runs the CUDA kernels, "cpu" their plain PyTorch
    versions."""

    camera: PinholeCamera
    device: str | torch.device = "cuda"
    voxel_size: float = 0.0125
    truncation: float = 0.1
    capacity: int = 16384
    table_size: int = 1 << 16
    kmax: int = 8192  # touched-key buffer; `maybe_grow` doubles it after saturation
    stride: int = 8  # touched-key pixel subsample; a 0.1 m block spans >= 12.9 px at 4 m
    iters: tuple[int, ...] = dense.DEFAULT_ITERS

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._state: FusedState | None = None
        self._poses: list[torch.Tensor] = []
        self._rmses: list[torch.Tensor] = []
        self._sat: list[torch.Tensor] = []
        self._sat_checked = 0
        self.kmax_growth: list[tuple[int, int]] = []  # (frame, new kmax)
        self.frame_count = 0

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def _init(self, gray: torch.Tensor, depth: torch.Tensor, rgb: torch.Tensor | None) -> None:
        """Frame 0: pyramids, fresh pool and table, fuse at identity."""
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        vox = tsdf_slots.make_pool(self.capacity, self.device)
        table, _ = _integrate(
            vox, dh.make_table(self.table_size, self.capacity, self.device),
            bilateral_filter(depth), gray, rgb, eye, self.camera, self.voxel_size,
            self.truncation, self.kmax, self.stride, INIT_CLAIM_ROUNDS,
        )
        pyr = dense.preprocess_frame(gray, depth, self.camera)
        self._state = FusedState(pyr, eye, eye, table, vox)
        self._poses.append(eye)
        self._rmses.append(torch.zeros((), dtype=torch.float32, device=self.device))

    def process_frame(self, gray, depth, rgb=None) -> None:
        """Track and fuse one (H, W) gray + depth frame (numpy or tensor).

        With an (H, W, 3) `rgb` the volume takes its colour from it; without,
        r = g = b = gray. Tracking reads gray only."""
        gray = self._tensor(gray)
        depth = self._tensor(depth)
        if rgb is not None:
            rgb = self._tensor(rgb)
        self.frame_count += 1
        if self._state is None:
            self._init(gray, depth, rgb)
            return
        self._state, out = _frame_body(
            self._state, gray, depth, rgb, self.camera, self.voxel_size, self.truncation,
            self.kmax, self.stride, self.iters,
        )
        self._poses.append(out.T_w)
        self._rmses.append(out.rmse)
        self._sat.append(out.keys_saturated)

    def process_chunk(self, grays, depths, rgbs=None) -> None:
        """Process a stack of K frames in order: grays and depths (K, H, W),
        rgbs optional (K, H, W, 3)."""
        grays = self._tensor(grays)
        depths = self._tensor(depths)
        rgbs = [None] * len(grays) if rgbs is None else self._tensor(rgbs)
        for g, d, c in zip(grays, depths, rgbs):
            self.process_frame(g, d, c)

    def maybe_grow(self, threshold: float = 0.85) -> bool:
        """Double the pool (and, if needed, the hash table) when occupancy
        crosses `threshold`; call between chunks on long sequences.

        Pool rows keep their slots; the table keeps its cells, or is rebuilt
        at double size with `insert_at` once its load factor would pass 1/2.
        Also doubles `kmax` when any frame since the last call saturated the
        touched-key buffer. Costs host syncs (the counters are read)."""
        if self._state is None:
            return False
        fresh = self._sat[self._sat_checked :]
        if fresh:
            self._sat_checked = len(self._sat)
            if bool(torch.stack(fresh).any()):
                self.kmax *= 2
                self.kmax_growth.append((self.frame_count, self.kmax))
        na = int(self._state.table.num_active)
        if na <= threshold * self.capacity:
            return False
        st = self._state
        new_cap = self.capacity * 2
        old = st.vox
        grown = torch.cat([
            old[: self.capacity],
            tsdf_slots.make_pool(self.capacity, self.device)[: self.capacity],
            old[self.capacity :],  # the trash row stays last
        ])
        tbl = st.table
        bc = torch.zeros((new_cap, 3), dtype=torch.int32, device=self.device)
        bc[: self.capacity] = tbl.block_coords
        tbl = tbl._replace(block_coords=bc)
        if new_cap > tbl.table_keys.shape[0] // 2:
            # rebuild the hash table at double size, same slots
            c = torch.clamp(bc + 512, 0, 1023)
            packed = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
            slot_ids = torch.arange(new_cap, dtype=torch.int32, device=self.device)
            keys = torch.where(slot_ids < na, packed, tsdf_ops.INVALID_KEY)
            new_tbl = dh.make_table(tbl.table_keys.shape[0] * 2, new_cap, self.device)
            new_tbl = dh.insert_at(new_tbl, keys, slot_ids)
            # carry the historical overflow and any keys the rebuild dropped
            tbl = new_tbl._replace(overflow=st.table.overflow + new_tbl.overflow)
            self.table_size = new_tbl.table_keys.shape[0]
        self.capacity = new_cap
        self._state = st._replace(vox=grown, table=tbl)
        return True

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """One sync: fetch the trajectory (N, 4, 4) and per-frame rmse (N,)."""
        return (
            torch.stack(self._poses).cpu().numpy(),
            torch.stack(self._rmses).cpu().numpy(),
        )

    @property
    def num_active(self) -> int:
        return int(self._state.table.num_active) if self._state else 0

    @property
    def overflow(self) -> int:
        return int(self._state.table.overflow) if self._state else 0

    @property
    def key_saturated_frames(self) -> int:
        """Frames whose touched-key buffer hit kmax (some blocks may have
        integrated a frame late). One fetch."""
        return int(torch.stack(self._sat).sum()) if self._sat else 0

    def to_volume(self) -> TSDFVolume:
        """The live pool as a TSDFVolume (no copy): block i at slot i, as the
        hash table allocated them. One fetch of the block coords. The volume
        shares the pool, so frames processed later change its voxels but
        not its block list: call again after them."""
        st = self._state
        if st is None:
            raise RuntimeError("to_volume before any frame was processed")
        na = int(st.table.num_active)
        vol = TSDFVolume(self.voxel_size, self.truncation, max_weight=MAX_WEIGHT, vox=st.vox)
        vol.allocate(st.table.block_coords[:na].cpu().numpy())
        return vol
