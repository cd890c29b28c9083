"""The touched-key cap of the post-hoc and pipelined integration paths
(`TSDFVolume.integrate`, `PipelinedDenseFusion`), on the CPU.

A frame whose touched block keys fill the cap counts in
`key_saturated_frames`, and its key pass is redone at a larger cap, so a
run at a cap of 16 keys allocates and fuses exactly what an uncapped run
does (blocks equal as sets, voxels bit-equal).
"""

import numpy as np
import pytest
import torch

from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.integration.blocks import TSDFVolume
from onepiece_tpu_torch.systems.pipeline import PipelinedDenseFusion
from onepiece_tpu_torch.utils import synthetic

CAM = TUM_CAMERA.pyramid(4)[3]  # 80x60
VOXEL = 0.02


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.orbit_trajectory(16)[:3]
    scene = synthetic.default_scene()
    out = [synthetic.render(scene, torch.from_numpy(p), CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.height, CAM.width,
                            num_steps=64) for p in poses]
    return poses, out


def _by_block(vol: TSDFVolume) -> dict:
    return {c: vol.vox[s] for c, s in vol.slot_of.items()}


def test_integrate_drops_no_block_at_a_small_cap(frames):
    poses, out = frames
    vols = {}
    for cap in (16, 1 << 16):
        vol = TSDFVolume(voxel_size=VOXEL, truncation=5 * VOXEL, device="cpu", max_blocks=cap)
        for (d, g), p in zip(out, poses):
            vol.integrate(d, torch.stack([g] * 3, -1), p, CAM)
        vols[cap] = vol
    small, full = vols[16], vols[1 << 16]
    assert full.key_saturated_frames == 0 and full.num_active > 1000
    # the first frame fills 16 keys; the cap then doubles past what later frames touch
    assert small.key_saturated_frames == 1 and small.max_blocks > 16
    assert set(small.slot_of) == set(full.slot_of)
    a, b = _by_block(small), _by_block(full)
    assert all(torch.equal(a[c], b[c]) for c in a)


def test_pipeline_reports_and_repairs_saturated_frames(frames):
    _, out = frames
    pipes = {}
    for cap in (16, 1 << 16):
        pipe = PipelinedDenseFusion(CAM, "cpu", voxel_size=VOXEL, max_blocks=cap)
        for d, g in out:
            pipe.process_frame(g, d)
        poses, _ = pipe.finalize()
        pipes[cap] = (pipe, poses)
    (small, ps), (full, pf) = pipes[16], pipes[1 << 16]
    assert np.array_equal(ps, pf)
    # the first two frames' keys were taken at the cap of 16 before the host
    # saw the first frame's count
    assert (small.key_saturated_frames, full.key_saturated_frames) == (2, 0)
    assert set(small.volume.slot_of) == set(full.volume.slot_of)
    a, b = _by_block(small.volume), _by_block(full.volume)
    assert all(torch.equal(a[c], b[c]) for c in a)
