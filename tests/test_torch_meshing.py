"""Parity of the port's meshing slice with the JAX package: marching cubes,
TSDFVolume (integrate, extract_mesh), volume_ops, PLY output, the pipelined
fusion loop and the two reconstruction CLIs.

Tolerances:
  - marching cubes (plain version) vs JAX `gather_neighbors` +
    `extract_block_triangles` + `compact_triangles`: valid masks and
    triangle counts equal, rows in the same order, vertices and colours
    within 1e-6 (XLA's CPU code may fuse a multiply-add in the colour
    interpolation);
  - `TSDFVolume.extract_mesh` on the JAX fused loop's pool (npz round trip)
    vs JAX `extract_mesh`: the same rows in the same order within 1e-6;
  - `TSDFVolume.integrate` vs the exact oracle `integrate_blocks`: weights
    equal, sdf and colour within 1e-6; vs JAX `TSDFVolume.integrate`
    (`integrate_blocks_matmul`): {block key -> row} maps equal, weights
    equal, sdf < 5e-4 and colour < 5e-3. Both allow <= 1e-4 of the voxels
    to differ: a voxel that projects onto a pixel boundary may round to the
    neighbouring pixel after a last-bit difference in the transform;
  - volume_ops: save / load exact both ways; merge within 1e-6;
    transform within 1e-5 (trilinear and nearest, identity and a rigid T);
  - `dedup_triangle_soup`: equal outputs;
  - `PipelinedDenseFusion`: poses equal to the port's fused loop (same
    tracker, same initial poses), its volume equal to eager integration at
    those poses; against the JAX pipeline (slow) poses within the 3 mm
    tracker band (ROADMAP queue 3) and the block sets within 0.5 % (the
    pose difference moves a few keys at block boundaries).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry import se3 as jse3
from onepiece_tpu.geometry.camera import PinholeCamera as JCamera
from onepiece_tpu.geometry.camera import TUM_CAMERA as JCAM
from onepiece_tpu.integration import blocks as jblocks
from onepiece_tpu.integration import volume_ops as jvo
from onepiece_tpu.io import ply as jply
from onepiece_tpu.ops import marching_cubes as jmc
from onepiece_tpu.ops import mc_tables as jtables
from onepiece_tpu.ops import tsdf as jtsdf
from onepiece_tpu.systems import fused_slam as jfs
from onepiece_tpu.utils import synthetic as jsyn
from onepiece_tpu_torch.geometry import se3 as tse3
from onepiece_tpu_torch.geometry.camera import PRESETS, PinholeCamera
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA as TCAM
from onepiece_tpu_torch.integration import blocks as tblocks
from onepiece_tpu_torch.integration import volume_ops as tvo
from onepiece_tpu_torch.io import ply as tply
from onepiece_tpu_torch.ops import marching_cubes as tmc
from onepiece_tpu_torch.ops import mc_tables as ttables
from onepiece_tpu_torch.ops import tsdf as ttsdf
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
from onepiece_tpu_torch.systems.pipeline import PipelinedDenseFusion

REPO = Path(__file__).resolve().parent.parent
VOX, TRUNC = 0.0125, 0.1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs: the test workers share the
    host's cores, and thousands of small operations stall each other's
    thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def orbit():
    """The first 4 frames of the 16-frame orbit at 80x60 (48 sphere-tracing
    steps, as the fused-loop parity tests render them)."""
    cam = JCAM.pyramid(4)[3]
    poses = jsyn.orbit_trajectory(16)[:4]
    scene = jsyn.default_scene()
    out = [jsyn.render(scene, jnp.asarray(p), cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width, num_steps=48)
           for p in poses]
    grays = np.stack([np.array(g) for _, g in out])
    depths = np.stack([np.array(d) for d, _ in out])
    return poses, grays, depths


@pytest.fixture(scope="module")
def jax_fused_volume(orbit, tmp_path_factory):
    """The JAX fused loop's volume after the 4 frames (Pallas TSDF kernel in
    interpret mode), saved as npz: (JAX volume, npz path)."""
    _, grays, depths = orbit
    slam = jfs.FusedDenseFusion(JCAM.pyramid(4)[3], interpret=True, capacity=2048, table_size=1 << 12,
                                kmax=512, stride=2)
    for g, d in zip(grays, depths):
        slam.process_frame(g, d)
    vol = slam.to_volume()
    path = str(tmp_path_factory.mktemp("vol") / "jax_fused.npz")
    jvo.save_volume(vol, path)
    return vol, path


def test_mc_tables_match_jax():
    np.testing.assert_array_equal(ttables.TRI_TABLE, jtables.TRI_TABLE)
    np.testing.assert_array_equal(ttables.TRI_COUNTS, jtables.TRI_COUNTS)
    np.testing.assert_array_equal(ttables.EDGE_CORNERS, jtables.EDGE_CORNERS)
    t, c = ttables.TRI_TABLE, ttables.TRI_COUNTS
    assert t.shape == (256, 5, 3) and ttables.MAX_TRIS_PER_VOXEL == 5
    assert c[0] == 0 and c[255] == 0
    for corner in range(8):  # single-corner cases emit exactly 1 triangle
        assert c[1 << corner] == 1
        assert c[255 ^ (1 << corner)] == 1
    # rows hold their counts' triangles, then -1 padding
    assert all((t[k, : c[k]] >= 0).all() and (t[k, c[k]:] == -1).all() for k in range(256))
    np.testing.assert_array_equal(tmc.NEIGHBOR_OFFSETS, jmc.NEIGHBOR_OFFSETS)


def _random_blocks(case, rng):
    """A pool of P blocks in the JAX layout and B <= 64 blocks to mesh: an
    analytic sphere over a 4x4x4 block grid, or random sdf / weight / colour
    with some zero weights; neighbours absent at the grid's far faces and,
    in the random case, at random."""
    p = 64
    coords = np.array([[x, y, z] for x in range(-2, 2) for y in range(-2, 2) for z in range(-2, 2)])
    if case == "sphere":
        centers = np.asarray(jtsdf.voxel_centers_world(jnp.asarray(coords, jnp.int32), 0.05))
        sdf = np.clip((np.linalg.norm(centers - [0.02, -0.01, 0.03], axis=-1) - 0.55) / 0.15, -1, 1)
        weight = np.ones_like(sdf)
        weight[5, :40] = 0.0  # a few unobserved voxels
    else:
        sdf = rng.uniform(-1.3, 1.3, (p, 512))
        weight = rng.integers(0, 4, (p, 512)).astype(np.float64)
        weight[:, ::2] = np.maximum(weight[:, ::2], 1.0)
    color = rng.uniform(0, 1, (p, 512, 3))
    slot_of = {tuple(c): i for i, c in enumerate(coords.tolist())}
    nbr = np.array([[slot_of.get(tuple(c + o), -1) for o in jmc.NEIGHBOR_OFFSETS.tolist()] for c in coords.tolist()])
    if case == "random":
        nbr[rng.uniform(size=nbr.shape) < 0.2] = -1
    f32 = np.float32
    return (sdf.reshape(p, 8, 8, 8).astype(f32), weight.reshape(p, 8, 8, 8).astype(f32),
            color.reshape(p, 8, 8, 8, 3).astype(f32), nbr, coords.astype(np.int32))


@pytest.mark.parametrize("case", ["sphere", "random"])
def test_block_triangles_match_jax(case):
    sdf, weight, color, nbr, coords = _random_blocks(case, np.random.default_rng(3))
    j_nbr = [jmc.gather_neighbors(jnp.asarray(sdf), jnp.asarray(nbr), 999.0),
             jmc.gather_neighbors(jnp.asarray(weight), jnp.asarray(nbr), 0.0),
             jnp.stack([jmc.gather_neighbors(jnp.asarray(color[..., i]), jnp.asarray(nbr), 0.0) for i in range(3)], -1)]
    t_nbr = [tmc.gather_neighbors(_t(sdf), _t(nbr), 999.0), tmc.gather_neighbors(_t(weight), _t(nbr), 0.0),
             tmc.gather_neighbors(_t(color), _t(nbr), 0.0)]
    for a, b in zip(t_nbr, j_nbr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tv_j, tc_j, valid_j = jmc.extract_block_triangles(
        jnp.asarray(sdf), jnp.asarray(weight), jnp.asarray(color), *j_nbr, jnp.asarray(coords), 0.05)
    tv_t, tc_t, valid_t = tmc.extract_block_triangles_reference(
        _t(sdf), _t(weight), _t(color), *t_nbr, _t(coords), 0.05)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    n = int(valid_t.sum())
    assert n > (800 if case == "sphere" else 20000)
    out_j = jmc.compact_triangles(tv_j, tc_j, valid_j, cap=n + 7)
    assert int(out_j[2]) == n
    v_t, c_t = tmc.compact_triangles_reference(tv_t, tc_t, valid_t)
    assert v_t.shape == c_t.shape == (n, 3, 3)
    assert np.abs(v_t.numpy() - np.asarray(out_j[0])[:n]).max() <= 1e-6
    assert np.abs(c_t.numpy() - np.asarray(out_j[1])[:n]).max() <= 1e-6

    # the pool form, in chunks: the same rows
    vox = np.zeros((len(sdf) + 1, 5, 512), np.float32)
    vox[:-1, 0], vox[:-1, 1] = sdf.reshape(-1, 512), weight.reshape(-1, 512)
    vox[:-1, 2:5] = np.moveaxis(color.reshape(-1, 512, 3), -1, 1)
    slots = torch.arange(len(sdf), dtype=torch.int32)
    args = (torch.from_numpy(vox), slots, _t(nbr).int(), _t(coords), 0.05)
    v_p, c_p = tmc.extract_triangles(*args)
    v_c, c_c = tmc.extract_triangles_reference(*args, chunk=5)
    for a, b in ((v_p, v_t), (c_p, c_t), (v_c, v_t), (c_c, c_t)):
        assert torch.equal(a, b)


def test_absent_own_slots_mesh_nothing():
    """Slots outside the pool are absent blocks: no triangles from them."""
    sdf, weight, color, nbr, coords = _random_blocks("sphere", np.random.default_rng(3))
    vox = np.zeros((len(sdf) + 1, 5, 512), np.float32)
    vox[:-1, 0], vox[:-1, 1] = sdf.reshape(-1, 512), weight.reshape(-1, 512)
    slots = torch.arange(len(sdf), dtype=torch.int32)
    full = tmc.extract_triangles(torch.from_numpy(vox), slots, _t(nbr).int(), _t(coords), 0.05)[0]
    slots[:] = -1
    assert tmc.extract_triangles(torch.from_numpy(vox), slots, _t(nbr).int(), _t(coords), 0.05)[0].shape[0] == 0
    slots[:] = len(sdf) + 1
    assert tmc.extract_triangles(torch.from_numpy(vox), slots, _t(nbr).int(), _t(coords), 0.05)[0].shape[0] == 0
    assert full.shape[0] > 800


def test_extract_mesh_on_the_jax_fused_pool(jax_fused_volume):
    """The JAX fused loop's volume, saved as npz and loaded by the port,
    meshes to the JAX package's triangles, row for row."""
    vol_j, path = jax_fused_volume
    # a cap of 5 triangles per voxel drops nothing; the default cap (96 per
    # block, 12,288 per chunk of 128 blocks) drops triangles of full chunks here
    tv_j, tc_j = vol_j.extract_mesh(cap_per_block=512 * 5)
    vol_t = tvo.load_volume(path, "cpu")
    assert vol_t.num_active == vol_j.num_active > 500
    assert vol_t.slot_of == vol_j.slot_of
    tv_t, tc_t = vol_t.extract_mesh()
    assert tv_t.shape == tv_j.shape and tv_t.shape[0] > 20000
    assert len(vol_j.extract_mesh()[0]) < len(tv_t)
    assert np.abs(tv_t - tv_j).max() <= 1e-6
    assert np.abs(tc_t - tc_j).max() <= 1e-6


def test_jax_chunk_cap_drops_triangles_the_port_keeps():
    """One block of random sdf has > 96 triangles: the JAX package's chunk
    cap (chunk * cap_per_block rows) drops the rest; the port drops none."""
    rng = np.random.default_rng(5)
    sdf = rng.uniform(-1, 1, (1, 8, 8, 8)).astype(np.float32)
    vol_j = jblocks.TSDFVolume(voxel_size=0.05, truncation=0.3, capacity=16)
    vol_j.allocate(np.array([[0, 0, 0]]))
    vol_j.sdf = vol_j.sdf.at[:1].set(jnp.asarray(sdf))
    vol_j.weight = vol_j.weight.at[:1].set(1.0)
    tv_j, _ = vol_j.extract_mesh(chunk=1, cap_per_block=96)
    vol_t = tblocks.TSDFVolume(voxel_size=0.05, truncation=0.3, capacity=16, device="cpu")
    vol_t.allocate(np.array([[0, 0, 0]]))
    vol_t.sdf[:1] = _t(sdf)
    vol_t.weight[:1] = 1.0
    tv_t, _ = vol_t.extract_mesh(chunk=1, cap_per_block=96)
    assert len(tv_j) == 96 < len(tv_t)
    assert np.abs(tv_t[:96] - tv_j).max() <= 1e-6


def _sphere_volume(device="cpu"):
    """The analytic sphere (r 0.5 at the origin) over 4x4x4 blocks of 0.05 m
    voxels, weight 1 everywhere: a closed surface inside the blocks."""
    vol = tblocks.TSDFVolume(voxel_size=0.05, truncation=10.0, capacity=256, device=device)
    vol.allocate(np.array([[x, y, z] for x in range(-2, 2) for y in range(-2, 2) for z in range(-2, 2)]))
    n = vol.num_active
    centers = ttsdf.voxel_centers_world(torch.from_numpy(vol.active_coords()).to(vol.device), vol.voxel_size)
    vol.vox[:n, 0] = torch.clamp((torch.linalg.norm(centers, dim=-1) - 0.5) / vol.truncation, -1, 1)
    vol.vox[:n, 1] = 1.0
    return vol


def check_watertight_sphere(tv, tc):
    """Every undirected edge in exactly 2 faces, consistent winding, V - E +
    F = 2, vertices on the sphere; returns the face count."""
    verts, faces, _ = tply.dedup_triangle_soup(tv, tc)
    assert len(faces) > 100
    assert np.abs(np.linalg.norm(verts, axis=-1) - 0.5).max() < 0.06
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    uniq, counts = np.unique(np.sort(edges, axis=1), axis=0, return_counts=True)
    assert (counts == 2).all(), np.bincount(counts)
    assert (np.unique(edges, axis=0, return_counts=True)[1] == 1).all()  # consistent winding
    assert len(verts) - len(uniq) + len(faces) == 2
    return len(faces)


def test_marching_cubes_watertight_on_full_field():
    tv, tc = _sphere_volume().extract_mesh()
    check_watertight_sphere(tv, tc)


def _frames_jax_and_port(orbit, n):
    """(depth, rgb, T_wc) of the first n orbit frames, rgb seeded uniform."""
    poses, grays, depths = orbit
    rgbs = np.random.default_rng(2).uniform(0, 1, (*grays.shape, 3)).astype(np.float32)
    return [(depths[i], rgbs[i], np.asarray(poses[i], np.float32)) for i in range(n)]


def test_integrate_matches_oracle_and_jax(orbit):
    cam_j, cam_t = JCAM.pyramid(4)[3], TCAM.pyramid(4)[3]
    frames = _frames_jax_and_port(orbit, 2)
    vol_j = jblocks.TSDFVolume(voxel_size=VOX, truncation=TRUNC, capacity=1024)
    vol_t = tblocks.TSDFVolume(voxel_size=VOX, truncation=TRUNC, capacity=1024, device="cpu")
    for k, (d, rgb, T) in enumerate(frames):
        prior = vol_t.vox.clone()
        vol_j.integrate(jnp.asarray(d), jnp.asarray(rgb), jnp.asarray(T), cam_j)
        vol_t.integrate(d, rgb, T, cam_t)
    assert vol_t.capacity == vol_j.capacity == 2048  # both grew once
    assert vol_t.slot_of == vol_j.slot_of and vol_t.num_active > 1024
    na = vol_t.num_active

    # the last frame against the exact oracle on the same prior rows
    d, rgb, T = frames[-1]
    keys = ttsdf.touched_block_keys(_t(d), _t(T), cam_t.fx, cam_t.fy, cam_t.cx, cam_t.cy, VOX, TRUNC)
    coords = ttsdf.unpack_block_keys(keys)
    rows = np.array([vol_t.slot_of[tuple(c)] for c in coords.tolist()])
    p = prior.numpy()[rows]
    s_o, w_o, c_o = jtsdf.integrate_blocks(
        jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1]), jnp.asarray(np.moveaxis(p[:, 2:5], 1, -1)),
        jnp.asarray(coords, jnp.int32), jnp.ones(len(rows), bool), jnp.asarray(d), jnp.asarray(rgb),
        jnp.asarray(tse3.inverse_T(_t(T)).numpy()), cam_j.fx, cam_j.fy, cam_j.cx, cam_j.cy, VOX, TRUNC,
    )
    port = vol_t.vox.numpy()[rows]
    updated = port[:, 1] != p[:, 1]
    assert updated.sum() > 20000
    np.testing.assert_array_equal(port[:, 1], np.asarray(w_o))
    # a voxel that projects onto a pixel boundary may round to the
    # neighbouring pixel (a last-bit difference in the transform): 1 of ~400k here
    close = ((np.abs(port[:, 0] - np.asarray(s_o)) <= 1e-6)
             & (np.abs(np.moveaxis(port[:, 2:5], 1, -1) - np.asarray(c_o)) <= 1e-6).all(-1))
    assert (~close).sum() <= 1e-4 * updated.sum()

    # against the JAX volume (integrate_blocks_matmul), voxel by voxel: all
    # but the few at a pixel boundary within the bands
    w_t = vol_t.weight[:na].reshape(na, -1).numpy()
    ok = ((w_t == np.asarray(vol_j.weight[:na]).reshape(na, -1))
          & (np.abs(vol_t.sdf[:na].reshape(na, -1).numpy() - np.asarray(vol_j.sdf[:na]).reshape(na, -1)) < 5e-4)
          & (np.abs(vol_t.color[:na].reshape(na, -1, 3).numpy()
                    - np.asarray(vol_j.color[:na]).reshape(na, -1, 3)) < 5e-3).all(-1))
    seen = w_t > 0
    assert seen.sum() > 100000 and (~ok).sum() <= 1e-4 * seen.sum()


def test_neighbor_slots_device_matches_host_dict():
    rng = np.random.default_rng(4)
    coords = np.unique(rng.integers(-6, 6, (700, 3)), axis=0)
    coords = np.concatenate([coords, [[511, 511, 511], [510, 511, 511], [-512, -512, -512], [511, 0, 0]]])
    vol = tblocks.TSDFVolume(capacity=2048, device="cpu")
    vol.allocate(coords)
    host = vol._neighbor_slots()
    assert (host >= 0).mean() > 0.2 and (host < 0).any()
    dev = tblocks.neighbor_slots_device(torch.from_numpy(vol.active_coords()))
    assert dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy(), host)


def _analytic_volumes(center, radius=0.3, voxel=0.05, extent=2):
    """The same analytic sphere volume in both packages (JAX, port)."""
    coords = np.array([[x, y, z] for x in range(-extent, extent) for y in range(-extent, extent)
                       for z in range(-extent, extent)])
    vol_j = jblocks.TSDFVolume(voxel_size=voxel, truncation=voxel * 6, capacity=256)
    vol_j.allocate(coords)
    n = vol_j.num_active
    centers = jtsdf.voxel_centers_world(jnp.asarray(vol_j.active_coords(), jnp.int32), voxel)
    sdf = jnp.clip((jnp.linalg.norm(centers - jnp.asarray(center), axis=-1) - radius) / vol_j.truncation, -1, 1)
    col = np.random.default_rng(6).uniform(0, 1, (n, 8, 8, 8, 3)).astype(np.float32)
    vol_j.sdf = vol_j.sdf.at[:n].set(sdf.reshape(n, 8, 8, 8))
    vol_j.weight = vol_j.weight.at[:n].set(1.0)
    vol_j.color = vol_j.color.at[:n].set(jnp.asarray(col))
    vol_t = tblocks.TSDFVolume(voxel_size=voxel, truncation=voxel * 6, capacity=256, device="cpu")
    vol_t.allocate(coords)
    vol_t.sdf[:n] = _t(np.asarray(vol_j.sdf[:n]))
    vol_t.weight[:n] = 1.0
    vol_t.color[:n] = _t(col)
    return vol_j, vol_t


def _assert_volumes_equal(a_t, b_j, atol=0.0):
    assert a_t.slot_of == b_j.slot_of
    n = a_t.num_active
    for name in ("sdf", "weight", "color"):
        diff = np.abs(getattr(a_t, name)[:n].numpy() - np.asarray(getattr(b_j, name)[:n]))
        assert diff.max() <= atol, (name, diff.max())


def test_save_load_between_the_packages(tmp_path, jax_fused_volume):
    vol_j, path_j = jax_fused_volume
    # JAX -> port
    vol_t = tvo.load_volume(path_j, "cpu")
    _assert_volumes_equal(vol_t, vol_j)
    assert (vol_t.voxel_size, vol_t.truncation, vol_t.max_weight) == (vol_j.voxel_size, vol_j.truncation, 100.0)
    # port -> JAX, and port -> port
    path_t = str(tmp_path / "port.npz")
    tvo.save_volume(vol_t, path_t)
    _assert_volumes_equal(vol_t, jvo.load_volume(path_t))
    _assert_volumes_equal(tvo.load_volume(path_t, "cpu"), vol_j)


def test_merge_volumes_matches_jax():
    a_j, a_t = _analytic_volumes([0.0, 0.0, 0.0])
    b_j, b_t = _analytic_volumes([0.05, -0.02, 0.0], extent=1)
    b_t.vox[:, 1] = 3.0  # unequal weights
    b_j.weight = b_j.weight.at[:].set(3.0)
    m_t, m_j = tvo.merge_volumes(a_t, b_t), jvo.merge_volumes(a_j, b_j)
    assert m_t.num_active == m_j.num_active == a_t.num_active
    _assert_volumes_equal(m_t, m_j, atol=1e-6)
    far = tblocks.TSDFVolume(voxel_size=0.05, truncation=0.3, capacity=4, device="cpu")
    far.allocate(np.array([[5, 5, 5]]))
    far.vox[0, 0], far.vox[0, 1] = 0.5, 2.0
    m = tvo.merge_volumes(a_t, far)
    assert m.num_active == a_t.num_active + 1 and float(m.sdf[m.slot_of[(5, 5, 5)]].max()) == 0.5


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("motion", ["identity", "rigid"])
def test_transform_volume_matches_jax(nearest, motion):
    vol_j, vol_t = _analytic_volumes([0.05, -0.03, 0.04], radius=0.25)
    T = np.eye(4, dtype=np.float32) if motion == "identity" else np.asarray(
        jse3.se3_exp(jnp.asarray([0.08, 0.05, -0.06, 0.15, -0.1, 0.2], jnp.float32)))
    out_t = tvo.transform_volume(vol_t, T, nearest=nearest)
    out_j = jvo.transform_volume(vol_j, T, nearest=nearest)
    assert out_t.num_active == out_j.num_active >= vol_t.num_active
    _assert_volumes_equal(out_t, out_j, atol=1e-5)
    tv, _ = out_t.extract_mesh()
    assert len(tv) > 100


def test_dedup_triangle_soup_and_ply_roundtrip(tmp_path):
    tv, tc = _sphere_volume().extract_mesh()
    v_t, f_t, c_t = tply.dedup_triangle_soup(tv, tc)
    v_j, f_j, c_j = jply.dedup_triangle_soup(tv, tc)
    for a, b in ((v_t, v_j), (f_t, f_j), (c_t, c_j)):
        np.testing.assert_array_equal(a, b)
    for binary in (True, False):
        path = str(tmp_path / f"mesh_{binary}.ply")
        tply.write_ply_mesh(path, v_t, f_t, colors=c_t, binary=binary)
        back = tply.read_ply(path)
        np.testing.assert_array_equal(back["faces"], f_t)
        assert np.abs(back["vertices"] - v_t).max() <= (0.0 if binary else 1e-6)
        assert np.abs(back["colors"] - np.clip(c_t * 255, 0, 255).astype(np.uint8) / 255.0).max() < 1e-6
        jback = jply.read_ply(path)  # the JAX package reads it back the same
        np.testing.assert_array_equal(jback["faces"], back["faces"])


def test_camera_presets_and_project_match_jax():
    from onepiece_tpu.geometry.camera import PRESETS as JPRESETS

    assert PRESETS.keys() == JPRESETS.keys()
    for k, cam in PRESETS.items():
        assert (cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, cam.depth_scale) == (
            JPRESETS[k].fx, JPRESETS[k].fy, JPRESETS[k].cx, JPRESETS[k].cy, JPRESETS[k].width,
            JPRESETS[k].height, JPRESETS[k].depth_scale)
    pts = np.random.default_rng(7).uniform([-1, -1, -0.5], [1, 1, 3], (500, 3)).astype(np.float32)
    pts[:3, 2] = 0.0
    uv_t, z_t = PRESETS["tum"].project(_t(pts))
    uv_j, z_j = JPRESETS["tum"].project(jnp.asarray(pts))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-6)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))


CAM_160 = (100.0, 100.0, 79.5, 59.5, 160, 120, 1000.0)  # tests/test_misc.py's camera


def _misc_frames(n):
    scene = jsyn.default_scene()
    poses = jsyn.orbit_trajectory(n)
    fx, fy, cx, cy, w, h, _ = CAM_160
    out = [jsyn.render(scene, jnp.asarray(p), fx, fy, cx, cy, h, w) for p in poses]
    return poses, [(np.array(d), np.array(g)) for d, g in out]


def test_pipeline_matches_the_fused_loop_and_eager_integration(orbit):
    """The pipelined loop tracks as the fused loop does (same tracker and
    initial poses: equal poses) and its lagged volume equals eager
    integration of the same frames at those poses."""
    poses, grays, depths = orbit
    cam = TCAM.pyramid(4)[3]
    pipe = PipelinedDenseFusion(cam, device="cpu", voxel_size=0.03, truncation=0.15, volume_capacity=1024)
    for g, d in zip(grays, depths):
        pipe.process_frame(g, d)
    est, rmses = pipe.finalize()
    fused = FusedDenseFusion(cam, device="cpu", capacity=2048, table_size=1 << 12, kmax=512, stride=2)
    fused.process_chunk(grays, depths)
    np.testing.assert_array_equal(est, fused.finalize()[0])
    assert est.shape == (4, 4, 4) and np.isfinite(rmses).all()
    eager = tblocks.TSDFVolume(voxel_size=0.03, truncation=0.15, capacity=1024, device="cpu")
    from onepiece_tpu_torch.ops.image import bilateral_filter

    for g, d, T in zip(grays, depths, est):
        eager.integrate(bilateral_filter(_t(d)), np.repeat(g[..., None], 3, -1), T, cam)
    assert eager.slot_of == pipe.volume.slot_of and eager.num_active > 100
    assert torch.equal(eager.vox, pipe.volume.vox)


@pytest.mark.slow
def test_pipeline_matches_jax():
    """tests/test_misc.py's configuration: 5 orbit frames at 160x120."""
    from onepiece_tpu.systems.pipeline import PipelinedDenseFusion as JPipe

    poses, frames = _misc_frames(5)
    pipe_j = JPipe(JCamera(*CAM_160), voxel_size=0.03, truncation=0.15, volume_capacity=1024)
    pipe_t = PipelinedDenseFusion(PinholeCamera(*CAM_160), device="cpu", voxel_size=0.03, truncation=0.15,
                                  volume_capacity=1024)
    for d, g in frames:
        pipe_j.process_frame(g, d)
        pipe_t.process_frame(g, d)
    est_j, _ = pipe_j.finalize()
    est_t, _ = pipe_t.finalize()
    rel = [(np.linalg.inv(e[i - 1]) @ e[i]) for e in (est_j, est_t) for i in range(1, 5)]
    for a, b in zip(rel[:4], rel[4:]):
        assert np.abs(a[:3, 3] - b[:3, 3]).max() <= 3e-3 and np.abs(a[:3, :3] - b[:3, :3]).max() <= 3e-3
    # the block sets: the trackers differ by up to 3 mm, which moves a few
    # keys at block boundaries (and with them the slots of later blocks)
    kt, kj = set(pipe_t.volume.slot_of), set(pipe_j.volume.slot_of)
    assert len(kt ^ kj) <= 0.005 * len(kt | kj)


_NO_JAX = (
    "import sys, importlib.abc\n"
    "class NoJax(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'onepiece_tpu'):\n"
    "            raise ImportError(name + ' is blocked')\n"
    "sys.meta_path.insert(0, NoJax())\n"
)


def _run_without_jax(code: str, cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # the subprocess's torch, pinned as this module's is
    return subprocess.run([sys.executable, "-c", _NO_JAX + code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240)


def test_port_imports_without_jax(tmp_path):
    """Every module of the port imports where jax cannot be imported."""
    code = (
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import importlib, pkgutil, onepiece_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'onepiece_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules and 'onepiece_tpu' not in sys.modules\n"
        "print(len(mods))\n"
    )
    res = _run_without_jax(code, tmp_path)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 25


@pytest.mark.parametrize("tool", ["torch_fused_fusion", "torch_dense_fusion"])
def test_cli_writes_a_mesh_without_jax(tmp_path, tool):
    mesh = tmp_path / "mesh.ply"
    argv = [f"tools/{tool}.py", "--device", "cpu", "--synthetic", "4", "--scale", "8",
            "--out-mesh", str(mesh), "--out-traj", str(tmp_path / "traj.txt")]
    code = (
        "import runpy\n"
        f"sys.argv = {argv!r}\n"
        f"runpy.run_path({str(REPO / 'tools' / (tool + '.py'))!r}, run_name='__main__')\n"
        "assert 'jax' not in sys.modules and 'onepiece_tpu' not in sys.modules\n"
    )
    res = _run_without_jax(code, tmp_path)
    assert res.returncode == 0, res.stderr
    assert "mesh:" in res.stdout and "ATE RMSE" in res.stdout
    ply = tply.read_ply(str(mesh))
    assert len(ply["faces"]) > 1000 and np.isfinite(ply["vertices"]).all() and "colors" in ply
    assert len(tply.read_ply(str(mesh))["vertices"]) == int(res.stdout.split("mesh: ")[1].split()[0])


def test_merge_cli_without_jax(tmp_path):
    _, vol_t = _analytic_volumes([0.0, 0.0, 0.0])
    paths = [str(tmp_path / f"v{i}.npz") for i in range(2)]
    for p in paths:
        tvo.save_volume(vol_t, p)
    T = np.stack([np.eye(4), np.asarray(jse3.se3_exp(jnp.asarray([0.05, 0, 0, 0, 0, 0.1], jnp.float32)))])
    np.savetxt(tmp_path / "poses.txt", T.reshape(2, 16))
    argv = ["tools/torch_merge_submaps.py", *paths, "--trajectory", str(tmp_path / "poses.txt"),
            "--device", "cpu", "--out-mesh", str(tmp_path / "m.ply"), "--out-volume", str(tmp_path / "m.npz")]
    code = (
        "import runpy\n"
        f"sys.argv = {argv!r}\n"
        f"runpy.run_path({str(REPO / 'tools' / 'torch_merge_submaps.py')!r}, run_name='__main__')\n"
        "assert 'jax' not in sys.modules\n"
    )
    res = _run_without_jax(code, tmp_path)
    assert res.returncode == 0, res.stderr
    merged = tvo.load_volume(str(tmp_path / "m.npz"), "cpu")
    assert merged.num_active > vol_t.num_active
    assert len(tply.read_ply(str(tmp_path / "m.ply"))["faces"]) > 100
