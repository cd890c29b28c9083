"""Software-pipelined dense odometry + TSDF fusion.

Port of `onepiece_tpu/systems/pipeline.py:PipelinedDenseFusion`. Per frame,
the device runs the front end in order, enqueued without a host wait:
pyramid preprocessing, multi-scale dense tracking (the Gauss-Newton kernel),
the world-pose chain, the bilateral depth filter and the frame's touched
block keys. The keys go to pinned host memory with a non-blocking copy and a
CUDA event; they are read ONE FRAME LATER, when the next frame's front end
is already enqueued, so the copy hides behind device work. TSDF integration
therefore lags one frame: the host allocates the previous frame's blocks and
`TSDFVolume.integrate_prepared` runs the TSDF kernel on them. (The JAX
package runs the front end as one jitted program and starts its transfers
with `copy_to_host_async`.)

The key pass returns at most `max_blocks` keys. The host sees a frame's
count only when it reads the copied keys, a frame later; where they filled
the cap, the frame counts in `key_saturated_frames`, its key pass is redone
at twice the cap (a wait for the device, in that frame only) until the keys
fit, and later frames keep the larger cap. So no block is dropped. (The JAX
package caps at 4096 and drops the rest without a word.)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import PinholeCamera
from ..integration.blocks import TSDFVolume
from ..odometry import dense
from ..ops import tsdf as tsdf_ops
from ..ops.image import bilateral_filter


class _Pending(NamedTuple):
    """A frame awaiting integration: its device inputs and its keys' copy."""

    depth_filtered: torch.Tensor
    rgb: torch.Tensor
    T_world: torch.Tensor
    max_blocks: int  # the cap of its key pass
    keys_host: torch.Tensor  # pinned on CUDA runs
    copied: torch.cuda.Event | None  # recorded after the copy (CUDA runs)


@dataclasses.dataclass
class PipelinedDenseFusion:
    """Dense VO + TSDF fusion with one-frame-lagged integration. `device`
    "cuda" (the default) runs the kernels, "cpu" their plain versions."""

    camera: PinholeCamera
    device: str | torch.device = "cuda"
    voxel_size: float = 0.0125
    truncation: float = 0.1
    volume_capacity: int = 8192
    integrate_stride: int = 1
    max_blocks: int = 4096  # touched keys a frame's key pass returns; doubles when a frame fills it

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.volume = TSDFVolume(
            voxel_size=self.voxel_size, truncation=self.truncation,
            capacity=self.volume_capacity, device=self.device,
        )
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self._prev_pyr: dense.FramePyramid | None = None
        self._T_w = eye
        self._rel = eye
        self._pending: _Pending | None = None
        self._poses: list[torch.Tensor] = []
        self._rmses: list[torch.Tensor] = []
        self.frame_count = 0
        self.key_saturated_frames = 0  # frames whose touched keys filled the cap

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def _keys(self, depth_filtered: torch.Tensor, T_w: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        """The frame's touched block keys, copied to the host without a wait."""
        c = self.camera
        keys = tsdf_ops.touched_block_keys(
            depth_filtered, T_w, c.fx, c.fy, c.cx, c.cy, self.voxel_size, self.truncation,
            max_blocks=self.max_blocks,
        )
        if self.device.type != "cuda":
            return keys, None
        host = torch.empty(keys.shape, dtype=keys.dtype, pin_memory=True)
        host.copy_(keys, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def process_frame(self, gray, depth, rgb=None) -> None:
        """Track one (H, W) gray + depth frame and integrate the previous one.
        Colour from an (H, W, 3) `rgb`, else r = g = b = gray."""
        gray = self._tensor(gray)
        depth = self._tensor(depth)
        rgb = torch.stack([gray, gray, gray], -1) if rgb is None else self._tensor(rgb)
        fidx = self.frame_count
        self.frame_count += 1
        pyr = dense.preprocess_frame(gray, depth, self.camera)
        if fidx == 0:
            rmse = torch.zeros((), dtype=torch.float32, device=self.device)
        else:
            res = dense.dense_tracking(self._prev_pyr, pyr, self.camera, init_T=self._rel)
            self._T_w = dense.chain_pose(self._T_w, res.T_ts)
            self._rel = res.T_ts
            rmse = res.rmse
        d_f = bilateral_filter(depth)
        cap = self.max_blocks
        keys, event = self._keys(d_f, self._T_w)
        # integrate the PREVIOUS frame: its keys have had a frame to arrive
        self._drain_pending()
        if fidx % self.integrate_stride == 0:
            self._pending = _Pending(d_f, rgb, self._T_w, cap, keys, event)
        self._prev_pyr = pyr
        self._poses.append(self._T_w)
        self._rmses.append(rmse)

    def _drain_pending(self) -> None:
        if self._pending is None:
            return
        d_f, rgb, T_w, cap, keys, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        keys = keys.numpy()
        if int((keys != tsdf_ops.INVALID_KEY).sum()) >= cap:
            self.key_saturated_frames += 1
            c = self.camera
            while int((keys != tsdf_ops.INVALID_KEY).sum()) >= cap:
                cap = max(self.max_blocks, 2 * cap)
                keys = tsdf_ops.touched_block_keys(
                    d_f, T_w, c.fx, c.fy, c.cx, c.cy, self.voxel_size, self.truncation, max_blocks=cap,
                ).cpu().numpy()
            self.max_blocks = cap
        self.volume.integrate_prepared(d_f, rgb, T_w, self.camera, tsdf_ops.unpack_block_keys(keys))

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Flush the lagged integration; returns (poses (N, 4, 4), rmses (N,))."""
        self._drain_pending()
        return torch.stack(self._poses).cpu().numpy(), torch.stack(self._rmses).cpu().numpy()
