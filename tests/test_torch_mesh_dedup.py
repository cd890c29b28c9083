"""The port's vertex dedup on tensors (`ops/mesh_dedup.py`) against the JAX
package's numpy `onepiece_tpu/io/ply.py:dedup_triangle_soup` and the port's
numpy copy of it (`onepiece_tpu_torch/io/ply.py`), on the CPU: the same
vertices, faces and colours, in the same order, bit for bit (tolerance 0).

Soups: the port's fused loop's volume after 4 frames of the orbit at 80x60,
meshed; vertices at exact +-half-quantum ties; negative coordinates; no
colours; an empty soup; a soup whose faces all collapse.
"""

import numpy as np
import pytest
import torch

from onepiece_tpu.io import ply as jply
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.io import ply as tply
from onepiece_tpu_torch.ops.mesh_dedup import dedup_triangle_soup
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
from onepiece_tpu_torch.utils import synthetic

Q = np.float32(1e-5)  # the default quantum


def _check(tv: np.ndarray, tc: np.ndarray | None):
    """Device dedup vs both numpy versions; returns (vertices, faces)."""
    mine = dedup_triangle_soup(torch.from_numpy(tv), None if tc is None else torch.from_numpy(tc))
    for ref in (jply.dedup_triangle_soup(tv, tc), tply.dedup_triangle_soup(tv, tc)):
        for a, b in zip(mine, ref):
            if b is None:
                assert a is None
                continue
            assert a.dtype == torch.from_numpy(b).dtype
            np.testing.assert_array_equal(a.numpy(), b)
    return mine[0].numpy(), mine[1].numpy()


@pytest.fixture(scope="module")
def fused_soup():
    cam = TUM_CAMERA.pyramid(4)[3]  # 80x60
    scene = synthetic.default_scene()
    frames = [synthetic.render(scene, torch.from_numpy(p), cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width,
                               num_steps=48) for p in synthetic.orbit_trajectory(16)[:4]]
    slam = FusedDenseFusion(cam, device="cpu", capacity=2048, table_size=1 << 12, kmax=512, stride=2)
    slam.process_chunk(torch.stack([g for _, g in frames]), torch.stack([d for d, _ in frames]))
    return slam.to_volume().extract_mesh()


def test_dedup_on_the_fused_soup(fused_soup):
    tv, tc = fused_soup
    verts, faces = _check(tv, tc)
    assert len(tv) > 20000 and 0 < len(verts) < len(tv) and len(faces) > 0.99 * len(tv)
    assert np.isfinite(verts).all()


def _tied_soup(rng, n, offset):
    """(n, 3, 3) vertices whose keys sit at exact +-half-quantum ties (the
    float32 quotient v / quantum lands on k + 0.5 or k - 0.5) and at integers,
    around `offset` quanta; many rows repeat."""
    k = rng.integers(-40, 40, (n, 3, 3)).astype(np.float32) + np.float32(offset)
    v = (k + rng.choice(np.float32([0.0, 0.5, -0.5]), k.shape)) * Q
    return v.astype(np.float32), rng.uniform(0, 1, (n, 3, 3)).astype(np.float32)


@pytest.mark.parametrize("offset", [0.0, -123456.0, 98765.0])
def test_dedup_at_half_quantum_ties(offset):
    rng = np.random.default_rng(int(abs(offset)))
    tv, tc = _tied_soup(rng, 4000, offset)
    q = tv.reshape(-1) / Q
    assert np.sum(np.abs(q - np.floor(q)) == 0.5) > 1000  # exact ties, rounded half to even
    verts, _ = _check(tv, tc)
    assert len(verts) < tv.size // 3  # vertices merged


def test_dedup_negative_coordinates_and_no_colours():
    rng = np.random.default_rng(7)
    tv = rng.uniform(-3.0, -1.0, (500, 3, 3)).astype(np.float32)
    tv[250:] = tv[:250]  # repeated triangles share their vertices
    verts, faces = _check(tv, None)
    assert (verts < 0).all() and len(verts) == len(np.unique(tv.reshape(-1, 3), axis=0))
    assert len(faces) == 500


def test_dedup_empty_soup():
    verts, faces = _check(np.zeros((0, 3, 3), np.float32), np.zeros((0, 3, 3), np.float32))
    assert verts.shape == (0, 3) and faces.shape == (0, 3)


def test_dedup_all_degenerate_soup():
    """Every triangle's corners fall on one or two keys: no face is left."""
    rng = np.random.default_rng(8)
    p = rng.uniform(-1, 1, (300, 1, 3)).astype(np.float32)
    tv = np.repeat(p, 3, axis=1)
    tv[::2, 1] += Q * np.float32(0.25)  # within the same key
    tv[1::2, 2] += Q * np.float32(4.0)  # two distinct keys of three corners
    tc = rng.uniform(0, 1, tv.shape).astype(np.float32)
    verts, faces = _check(tv, tc)
    assert faces.shape == (0, 3) and len(verts) > 300
