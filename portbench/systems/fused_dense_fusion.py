"""The program's side of the dense fusion configuration: one scan of
`onepiece_tpu_torch.systems.fused_slam.FusedDenseFusion`, as a user runs
it offline.

A scan is a fresh system. Chunks go through `process_chunk`, then
`maybe_grow` (which grows the pool and the touched-key buffer between
chunks); the scan ends with `finalize`, `to_volume().
extract_mesh_tensors()` and the vertex dedup on the card, and no file.
"""

from __future__ import annotations

import torch

from onepiece_tpu_torch.geometry.camera import PinholeCamera
from onepiece_tpu_torch.ops.mesh_dedup import dedup_triangle_soup
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion

from ..reference.dense_fusion import ScanOut


class Scan:
    def __init__(self, cfg: dict, device: torch.device):
        c = cfg["camera"]
        cam = PinholeCamera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"], c["depth_scale"])
        self.slam = FusedDenseFusion(
            cam, device=device, voxel_size=cfg["voxel_size"], truncation=cfg["truncation"],
            capacity=cfg["capacity"], table_size=cfg["table_size"], kmax=cfg["kmax"], stride=cfg["stride"],
            iters=tuple(cfg["iters"]),
        )

    def feed(self, grays, depths, rgbs) -> None:
        self.slam.process_chunk(grays, depths, rgbs)

    def grow(self) -> bool:
        return self.slam.maybe_grow()

    def finish(self) -> ScanOut:
        poses, _ = self.slam.finalize()
        vol = self.slam.to_volume()
        tv, tc = vol.extract_mesh_tensors()
        v, f, c = dedup_triangle_soup(tv, tc)
        na = vol.num_active
        coords = torch.from_numpy(vol.block_coords[:na]).to(vol.device, torch.int32)
        return ScanOut(torch.from_numpy(poses).to(vol.device), vol.vox, coords, v, f, c)
